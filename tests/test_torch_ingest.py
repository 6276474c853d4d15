"""The port's host ingest and command line vs the JAX package's.

The same synthetic universe (``SyntheticConfig``, seeded) goes through
both packages:

- ``generate_synthetic_wrds`` frames are equal exactly
  (``pd.testing.assert_frame_equal``);
- the universe filter, the CRSP and Compustat transforms and the CCM merge
  give equal frames; ``long_to_dense`` and ``build_compact_daily`` equal
  arrays;
- ``build_panel`` at float64: identical NaN patterns, every entry within
  ``1e-12`` of its column's largest magnitude (a plain rtol of 1e-12 fails
  on rolling sums near zero, where both sides subtract cumulative sums of
  a large running total);
- ``run_pipeline(synthetic=True)`` at float64 on the CPU against the JAX
  package's run at the tolerances of ``tests/test_torch_pipeline.py``:
  Table 1 at rtol 1e-10 with N exact, the formatted Table 2 equal, the
  decile table at rtol 1e-8 with Months exact, Figure 1's plotted slopes at
  rtol 1e-8, the serving state at rtol 1e-8 (bounds 1e-10), counts exact;
- ``write_synthetic_cache`` → ``run_pipeline(raw_data_dir=...)`` equals the
  in-memory run exactly;
- both command lines with ``--output-dir`` write the same artifact files,
  and their pickled tables agree at the same tolerances.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu import pipeline as jax_pipeline
from fm_returnprediction_tpu.data import synthetic as jax_synthetic
from fm_returnprediction_tpu.data.wrds_pull import (
    subset_to_common_stock_and_exchanges as jax_subset,
)
from fm_returnprediction_tpu.panel import daily as jax_daily
from fm_returnprediction_tpu.panel import dense as jax_dense
from fm_returnprediction_tpu.panel import transform_compustat as jax_comp
from fm_returnprediction_tpu.panel import transform_crsp as jax_crsp
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.data import synthetic as port_synthetic
from fm_returnprediction_tpu_torch.data.wrds_pull import (
    subset_to_common_stock_and_exchanges as port_subset,
)
from fm_returnprediction_tpu_torch.panel import daily as port_daily
from fm_returnprediction_tpu_torch.panel import dense as port_dense
from fm_returnprediction_tpu_torch.panel import transform_compustat as port_comp
from fm_returnprediction_tpu_torch.panel import transform_crsp as port_crsp

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
CFG = dict(n_firms=150, n_months=130)


def _copy(frames):
    return {k: v.copy() for k, v in frames.items()}


@pytest.fixture(scope="module")
def frames():
    return (jax_synthetic.generate_synthetic_wrds(jax_synthetic.SyntheticConfig(**CFG)),
            port_synthetic.generate_synthetic_wrds(port_synthetic.SyntheticConfig(**CFG)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One synthetic run per package at float64 on the CPU, artifacts in
    two directories."""
    jax_out = tmp_path_factory.mktemp("jax_out")
    port_out = tmp_path_factory.mktemp("port_out")
    jax_res = jax_pipeline.run_pipeline(
        synthetic=True, synthetic_config=jax_synthetic.SyntheticConfig(**CFG),
        dtype=np.float64, output_dir=jax_out, compile_pdf=False)
    port_res = port_pipeline.run_pipeline(
        synthetic=True, synthetic_config=port_synthetic.SyntheticConfig(**CFG),
        device="cpu", dtype=torch.float64, output_dir=port_out, compile_pdf=False)
    return dict(jax=jax_res, port=port_res, jax_out=jax_out, port_out=port_out)


@pytest.mark.parametrize("key", list(jax_synthetic.FILE_NAMES))
def test_synthetic_frames_equal(frames, key):
    jax_frames, port_frames = frames
    pd.testing.assert_frame_equal(port_frames[key], jax_frames[key])


def test_universe_filter_and_transforms_equal(frames):
    jax_frames, port_frames = (_copy(f) for f in frames)
    for name in ("crsp_m", "crsp_d"):
        pd.testing.assert_frame_equal(port_subset(port_frames[name]),
                                      jax_subset(jax_frames[name]))
    pd.testing.assert_frame_equal(
        port_subset(port_frames["crsp_d"], columns=["permno", "dlycaldt", "retx"]),
        jax_subset(jax_frames["crsp_d"], columns=["permno", "dlycaldt", "retx"]))
    crsp_j = jax_crsp.calculate_market_equity(jax_subset(jax_frames["crsp_m"]))
    crsp_p = port_crsp.calculate_market_equity(port_subset(port_frames["crsp_m"]))
    pd.testing.assert_frame_equal(crsp_p, crsp_j)
    comp_j = jax_comp.expand_compustat_annual_to_monthly(
        jax_comp.calc_book_equity(jax_comp.add_report_date(jax_frames["comp"])))
    comp_p = port_comp.expand_compustat_annual_to_monthly(
        port_comp.calc_book_equity(port_comp.add_report_date(port_frames["comp"])))
    pd.testing.assert_frame_equal(comp_p, comp_j)
    pd.testing.assert_frame_equal(
        port_comp.merge_CRSP_and_Compustat(crsp_p, comp_p, port_frames["ccm"]),
        jax_comp.merge_CRSP_and_Compustat(crsp_j, comp_j, jax_frames["ccm"]))


def _merged(frames, subset, crsp, comp):
    data = _copy(frames)
    merged = comp.merge_CRSP_and_Compustat(
        crsp.calculate_market_equity(subset(data["crsp_m"])),
        comp.expand_compustat_annual_to_monthly(
            comp.calc_book_equity(comp.add_report_date(data["comp"]))),
        data["ccm"])
    merged["is_nyse"] = (merged["primaryexch"] == "N").astype(float)
    return data, merged


def test_long_to_dense_and_compact_daily_bit_equal(frames):
    jax_frames, port_frames = frames
    jdata, jmerged = _merged(jax_frames, jax_subset, jax_crsp, jax_comp)
    pdata, pmerged = _merged(port_frames, port_subset, port_crsp, port_comp)
    cols = ["retx", "prc", "shrout", "me", "be", "is_nyse"]
    want = jax_dense.long_to_dense(jmerged, "jdate", "permno", cols)
    got = port_dense.long_to_dense(pmerged, "jdate", "permno", cols)
    for name in ("values", "mask", "months", "ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.var_names == want.var_names
    months = np.unique(jmerged["jdate"].to_numpy())
    want = jax_daily.build_compact_daily(jax_subset(jdata["crsp_d"]),
                                         jdata["crsp_index_d"], months)
    got = port_daily.build_compact_daily(port_subset(pdata["crsp_d"]),
                                         pdata["crsp_index_d"], months)
    for name in ("row_values", "row_pos", "offsets", "ids", "mkt", "mkt_present",
                 "days", "day_month_id", "week_id", "week_month_id"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.n_weeks, got.n_months) == (want.n_weeks, want.n_months)


def test_build_panel_matches(frames):
    jax_frames, port_frames = frames
    want, jax_factors = jax_pipeline.build_panel(_copy(jax_frames), dtype=np.float64)
    got, port_factors = port_pipeline.build_panel(_copy(port_frames),
                                                  dtype=torch.float64, device="cpu")
    assert got.var_names == want.var_names and port_factors == jax_factors
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    np.testing.assert_array_equal(got.months, np.asarray(want.months))
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    g, w = got.values.numpy(), np.asarray(want.values)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    for k, name in enumerate(want.var_names):
        fin = np.isfinite(w[..., k])
        scale = np.abs(w[..., k][fin]).max()
        worst = np.abs(g[..., k] - w[..., k])[fin].max()
        assert worst <= 1e-12 * scale, (name, worst, scale)


def _assert_frames_close(got, want, rtol, exact_rows=()):
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    g, w = got.to_numpy(dtype=float), want.to_numpy(dtype=float)
    exact = np.isin(np.asarray(got.index), list(exact_rows))
    np.testing.assert_array_equal(g[exact], w[exact])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[~exact], w[~exact], rtol=rtol, atol=0, equal_nan=True)


def _assert_table_1_close(got, want):
    assert got.shape == want.shape == (15, 9)
    n_cols = [c for c in got.columns if c[1] == "N"]
    np.testing.assert_array_equal(got[n_cols].to_numpy(), want[n_cols].to_numpy())
    _assert_frames_close(got.drop(columns=n_cols), want.drop(columns=n_cols), 1e-10)


def test_synthetic_run_tables_match(runs):
    jax_res, port_res = runs["jax"], runs["port"]
    _assert_table_1_close(port_res.table_1, jax_res.table_1)
    assert port_res.table_2.equals(jax_res.table_2)
    assert port_res.decile_table.shape == (13, 3)
    _assert_frames_close(port_res.decile_table, jax_res.decile_table, 1e-8,
                         exact_rows=("Months",))


def test_synthetic_run_figure_matches(runs):
    """The JAX run returns Figure 1 drawn; its plotted lines are the
    rolling slopes the port returns as frames."""
    _, axes = runs["jax"].figure_1
    for ax, name in zip(axes, ("All stocks", "Large stocks")):
        frame = runs["port"].figure_1[name]
        assert len(ax.lines) == frame.shape[1]
        for line, col in zip(ax.lines, frame.columns):
            np.testing.assert_array_equal(np.asarray(line.get_xdata()), frame.index.values)
            want = np.asarray(line.get_ydata(), dtype=float)
            np.testing.assert_array_equal(np.isnan(frame[col].to_numpy()), np.isnan(want))
            np.testing.assert_allclose(frame[col].to_numpy(), want, rtol=1e-8, atol=0,
                                       equal_nan=True, err_msg=f"{name} {col}")


def test_synthetic_run_serving_state_matches(runs):
    got, want = runs["port"].serving_state, runs["jax"].serving_state
    np.testing.assert_array_equal(got.months, want.months)
    for name in ("coef", "slopes_bar", "intercept_bar", "gram", "moment", "ysum", "yy"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-8,
                                   atol=0, equal_nan=True, err_msg=name)
    for name in ("n_obs", "month_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("x_lo", "x_hi"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-10,
                                   atol=0, err_msg=name)


def test_synthetic_run_writes_the_same_artifacts(runs):
    names = sorted(p.name for p in runs["jax_out"].iterdir())
    assert sorted(p.name for p in runs["port_out"].iterdir()) == names
    assert {"data_saved.marker", "table_1.pkl", "table_2.tex", "figure_1.pdf",
            "decile_sorts.tex", "serving_state.npz", "research_report.tex"} <= set(names)


def test_raw_cache_run_equals_in_memory_run(runs, tmp_path, monkeypatch):
    """The legacy pandas route from a raw directory (the columnar route and
    the prepared slot are held in ``tests/test_torch_columnar.py`` and
    ``tests/test_torch_prepared.py``)."""
    monkeypatch.setenv("FMRP_PANEL_ROUTE", "legacy")
    monkeypatch.setenv("PREPARED_CACHE", "0")
    port_synthetic.write_synthetic_cache(tmp_path / "raw", port_synthetic.SyntheticConfig(**CFG))
    res = port_pipeline.run_pipeline(raw_data_dir=tmp_path / "raw", device="cpu",
                                     dtype=torch.float64, make_figure=False)
    want = runs["port"]
    assert {"load_raw_data", "panel/universe_filter", "factors/daily_ingest",
            "factors/long_to_dense"} <= set(res.stage_seconds)
    np.testing.assert_array_equal(res.panel.values.numpy(), want.panel.values.numpy())
    assert res.table_1.equals(want.table_1)
    assert res.table_2.equals(want.table_2)
    assert res.decile_table.equals(want.decile_table)
    for name in ("coef", "gram", "x_lo", "x_hi"):
        np.testing.assert_array_equal(getattr(res.serving_state, name),
                                      getattr(want.serving_state, name), err_msg=name)


def _cli(module, out, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), DTYPE="float64",
               JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    cmd = [sys.executable, "-m", module, "--synthetic", "--firms", "100",
           "--months", "120", "--output-dir", str(out), *extra]
    done = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=400)
    assert done.returncode == 0, done.stderr[-3000:]
    return done.stdout


def test_cli_writes_the_same_artifacts_as_the_jax_cli(tmp_path):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    _cli("fm_returnprediction_tpu.pipeline", jax_out, "--backend", "cpu")
    stdout = _cli("fm_returnprediction_tpu_torch.pipeline", port_out, "--device", "cpu")
    assert "guard_panel_contracts" in stdout and "save_artifacts" in stdout
    names = sorted(p.name for p in jax_out.iterdir())
    assert sorted(p.name for p in port_out.iterdir()) == names
    _assert_table_1_close(pd.read_pickle(port_out / "table_1.pkl"),
                          pd.read_pickle(jax_out / "table_1.pkl"))
    assert pd.read_pickle(port_out / "table_2.pkl").equals(
        pd.read_pickle(jax_out / "table_2.pkl"))


@pytest.mark.parametrize("argv", [
    ["--synthetic", "--replica-mode", "fiber"],  # not a replica mode
    ["--synthetic", "--fleet-size", "2", "--replica-mode", "fiber"],  # not a replica mode
    ["--synthetic", "--backend", "cpu"],        # the port's --device replaces it
    ["--firms", "10"],                          # --firms needs --synthetic
])
def test_cli_refuses_what_the_port_lacks(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        port_pipeline._main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("entry", ["cli", "run_pipeline"])
def test_default_device_without_gpu_raises(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "cli":
            port_pipeline._main(["--synthetic", "--firms", "10", "--months", "24"])
        else:
            port_pipeline.run_pipeline(synthetic=True)
