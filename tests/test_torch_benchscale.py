"""The port's real-scale synthetic generator (``data.benchscale``) against
``tests/test_benchscale.py``'s three cases, plus the frames themselves:
for the same arguments the port's generator gives the reference
package's frames, column for column."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from fm_returnprediction_tpu.data import benchscale as jax_benchscale
from fm_returnprediction_tpu_torch.data.benchscale import (
    flat_ranges,
    generate_benchscale_wrds,
    write_benchscale_cache,
)
from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig, generate_synthetic_wrds

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def both():
    bench = generate_benchscale_wrds(n_permnos=120, n_months=48)
    synth = generate_synthetic_wrds(SyntheticConfig(n_firms=30, n_months=24))
    return bench, synth


def test_benchscale_schema_covers_synthetic(both):
    bench, synth = both
    for key in synth:
        missing = set(synth[key].columns) - set(bench[key].columns)
        assert not missing, f"{key} missing columns: {missing}"


@pytest.mark.parametrize("kw", [dict(n_permnos=120, n_months=48),
                                dict(n_permnos=57, n_months=30, seed=7, start="1990-06-30",
                                     frac_nyse=0.5, frac_noncommon=0.2)],
                         ids=["default-seed", "other-args"])
def test_benchscale_frames_equal_the_reference_generator(kw, both):
    got = both[0] if kw == dict(n_permnos=120, n_months=48) else generate_benchscale_wrds(**kw)
    want = jax_benchscale.generate_benchscale_wrds(**kw)
    assert list(got) == list(want)
    for key in want:
        pd.testing.assert_frame_equal(got[key], want[key], check_exact=True, obj=key)
    starts, counts = np.array([3, 10, 0]), np.array([2, 0, 3])
    for a, b in zip(flat_ranges(starts, counts), jax_benchscale.flat_ranges(starts, counts)):
        np.testing.assert_array_equal(a, b)


def test_benchscale_pipeline_runs_and_recovers_beta(tmp_path):
    from fm_returnprediction_tpu_torch.pipeline import run_pipeline

    write_benchscale_cache(tmp_path, n_permnos=100, n_months=48)
    res = run_pipeline(raw_data_dir=tmp_path, make_figure=False, make_deciles=False,
                       compile_pdf=False, output_dir=None, device="cpu")
    beta = res.panel.var("beta").cpu().numpy()
    finite = np.isfinite(beta)
    assert finite.sum() > 200
    # betas were drawn U(0.3, 1.8); the factor loadings must be recoverable
    assert 0.6 < float(np.nanmean(beta)) < 1.5
    assert isinstance(res.table_2, pd.DataFrame) and len(res.table_2) > 0


def test_benchscale_cache_reuse(tmp_path):
    p1 = write_benchscale_cache(tmp_path, n_permnos=40, n_months=30)
    marker = (tmp_path / "benchscale.json").read_text()
    mtime = (tmp_path / "CRSP_stock_d.parquet").stat().st_mtime_ns
    p2 = write_benchscale_cache(tmp_path, n_permnos=40, n_months=30)
    assert p1 == p2
    assert (tmp_path / "CRSP_stock_d.parquet").stat().st_mtime_ns == mtime
    # the reference package reuses the port's cache (the same marker)
    assert jax_benchscale.write_benchscale_cache(tmp_path, n_permnos=40, n_months=30) == p1
    assert (tmp_path / "CRSP_stock_d.parquet").stat().st_mtime_ns == mtime
    write_benchscale_cache(tmp_path, n_permnos=41, n_months=30)
    assert (tmp_path / "benchscale.json").read_text() != marker
