"""The port's block bootstrap and bootstrap-SE table vs the JAX package's.

JAX draws each replicate's block starts from ``jax.random`` keys, whose bits
torch cannot reproduce, so the port splits the draw from the gather. Here
JAX's starts are rebuilt from the same keys (``jax.random.split(key, B)``,
then each predictor's ``jax.random.randint(k, (n_blocks,), 0,
max_start + 1)``) and handed to the port:

- ``replicate_means_from_starts`` equals JAX's ``bootstrap_replicate_means``
  at rtol 1e-12 (float64), NaN for a predictor with ``n_p <= L``;
- the whole table, with the port's ``draw_block_starts`` patched to JAX's
  starts, equals JAX's ``build_bootstrap_table`` at rtol 1e-10;
- the port's own draws are bit-identical for one seed, chunking the
  replicates changes nothing beyond summation order, and its SEs at
  B = 4,000 lie within 10% of JAX's (a statistical check with fixed seeds);
- ``n_replicates < 2`` raises, and ``mesh=`` matches one device; ``--bootstrap 32`` on the
  command line writes ``bootstrap_se.pkl`` and ``bootstrap_se.tex``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu.parallel.bootstrap import block_bootstrap_se as jax_block_se
from fm_returnprediction_tpu.parallel.bootstrap import (
    bootstrap_replicate_means as jax_replicate_means,
)
from fm_returnprediction_tpu.pipeline import build_panel, build_panel_prepared
from fm_returnprediction_tpu.reporting.bootstrap_table import (
    build_bootstrap_table as jax_bootstrap_table,
)
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.parallel import bootstrap
from fm_returnprediction_tpu_torch.reporting.bootstrap_table import build_bootstrap_table

pytestmark = pytest.mark.torch_port

L = 5


def _slopes(seed=5, t=90, p=4):
    """AR(1) slope series with gaps; predictor 3 keeps only L valid months
    (too short for a block bootstrap: NaN on both sides)."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((t, p))
    s = np.zeros((t, p))
    for i in range(1, t):
        s[i] = 0.4 * s[i - 1] + e[i]
    s += np.array([0.5, -0.2, 0.1, 0.3])
    valid = rng.random((t, p)) > 0.15
    valid[:, 3] = False
    valid[rng.choice(t, L, replace=False), 3] = True
    return np.where(valid, s, 0.0), valid


def jax_starts(seed: int, counts, n_replicates: int, block_length: int, n_months: int):
    """JAX's (B, P, n_blocks) block starts for ``jax.random.key(seed)``."""
    keys = jax.random.split(jax.random.key(seed), n_replicates)
    n_blocks = -(-n_months // block_length)
    out = []
    for c in np.asarray(counts).tolist():
        top = jnp.asarray(max(max(c, 1) - block_length, 0) + 1)
        out.append(np.asarray(jax.vmap(
            lambda k, _top=top: jax.random.randint(k, (n_blocks,), 0, _top))(keys)))
    return torch.from_numpy(np.stack(out, axis=1).astype(np.int64))


def test_replicate_means_equal_jax_given_jax_starts():
    slopes, valid = _slopes()
    b = 300
    want = np.asarray(jax_replicate_means(jnp.asarray(slopes), jnp.asarray(valid),
                                          jax.random.split(jax.random.key(11), b), L))
    counts = valid.sum(axis=0)
    starts = jax_starts(11, counts, b, L, slopes.shape[0])
    got = bootstrap.bootstrap_replicate_means(torch.from_numpy(slopes),
                                              torch.from_numpy(valid), starts, L).numpy()
    assert got.shape == want.shape == (b, 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 3]).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


def test_draws_lie_in_each_predictors_range():
    counts = torch.tensor([90, 40, 6, 5, 0])
    starts = bootstrap.draw_block_starts(counts, 2000, L, 90, torch.Generator().manual_seed(1))
    assert starts.shape == (2000, 5, 18) and starts.dtype == torch.int64
    top = torch.clamp_min(torch.clamp_min(counts, 1) - L, 0)
    assert bool((starts >= 0).all()) and bool((starts <= top[None, :, None]).all())
    for p in range(3):                         # every start value is drawn
        assert set(starts[:, p].unique().tolist()) == set(range(int(top[p]) + 1))


@pytest.fixture(scope="module")
def panels():
    capture = {}
    data = generate_synthetic_wrds(SyntheticConfig(n_firms=120, n_months=100))
    build_panel(data, dtype=np.float64, capture=capture)
    jp, factors = build_panel_prepared(capture["dense_base"], capture["compact_daily"],
                                       dtype=np.float64)
    masks = compute_subset_masks(jp)
    pp = DensePanel(values=torch.from_numpy(np.array(jp.values)), mask=np.asarray(jp.mask),
                    months=np.asarray(jp.months), ids=np.asarray(jp.ids),
                    var_names=list(jp.var_names))
    pmasks = {k: torch.from_numpy(np.array(m)) for k, m in masks.items()}
    return jp, masks, pp, pmasks, factors


def test_table_equals_jax_given_jax_starts(panels, monkeypatch):
    jp, masks, pp, pmasks, factors = panels
    seed, b = 4, 200
    monkeypatch.setattr(bootstrap, "draw_block_starts",
                        lambda counts, n, bl, t, generator: jax_starts(seed, counts, n, bl, t))
    got = build_bootstrap_table(pp, pmasks, factors, n_replicates=b, seed=seed)
    want = jax_bootstrap_table(jp, masks, factors, n_replicates=b, seed=seed)
    assert got.index.equals(want.index) and got.columns.equals(want.columns)
    assert got.shape == (24, 12)
    g, w = got.to_numpy(float), want.to_numpy(float)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isfinite(g).mean() > 0.9
    np.testing.assert_allclose(g, w, rtol=1e-10, atol=0, equal_nan=True)


def test_port_draws_are_bit_identical_for_one_seed(panels):
    _, _, pp, pmasks, factors = panels
    first = build_bootstrap_table(pp, pmasks, factors, n_replicates=64, seed=3)
    again = build_bootstrap_table(pp, pmasks, factors, n_replicates=64, seed=3)
    other = build_bootstrap_table(pp, pmasks, factors, n_replicates=64, seed=4)
    assert first.equals(again)
    assert not first.equals(other)
    model1 = first.loc["Model 1: Three Predictors"]
    assert (model1.xs("Boot SE", axis=1, level=1).to_numpy(float) > 0).all()


def test_chunking_changes_only_the_summation_order(monkeypatch):
    slopes, valid = _slopes()
    args = (torch.from_numpy(slopes), torch.from_numpy(valid))
    whole = bootstrap.block_bootstrap_se(*args, seed=2, n_replicates=500, block_length=L)
    monkeypatch.setattr(bootstrap, "REPLICATE_CHUNK_ELEMENTS", 7 * 4 * slopes.shape[0])
    chunked = bootstrap.block_bootstrap_se(*args, seed=2, n_replicates=500, block_length=L)
    again = bootstrap.block_bootstrap_se(*args, seed=2, n_replicates=500, block_length=L)
    np.testing.assert_array_equal(chunked.se.numpy(), again.se.numpy())
    np.testing.assert_allclose(chunked.se.numpy(), whole.se.numpy(), rtol=1e-12,
                               equal_nan=True)
    np.testing.assert_allclose(chunked.mean.numpy(), whole.mean.numpy(), rtol=1e-12,
                               equal_nan=True)


def test_se_within_ten_percent_of_jax_at_4000_replicates():
    slopes, valid = _slopes(seed=9, t=240, p=4)
    b = 4000
    want = jax_block_se(jnp.asarray(slopes), jnp.asarray(valid), jax.random.key(0),
                        n_replicates=b, block_length=L)
    got = bootstrap.block_bootstrap_se(torch.from_numpy(slopes), torch.from_numpy(valid),
                                       seed=0, n_replicates=b, block_length=L)
    g, w = got.se.numpy(), np.asarray(want.se)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = np.isfinite(w)
    assert ok.sum() == 3
    assert (np.abs(g[ok] / w[ok] - 1.0) < 0.10).all(), (g, w)
    assert got.n_replicates == b and got.block_length == L


def test_too_few_replicates_and_a_mesh_raise():
    """Too few replicates raise, on one device and on a mesh; the mesh route
    (the same draws split over 3 shards, B not a multiple of 3) is the
    one-device result up to summation order."""
    from fm_returnprediction_tpu_torch.parallel.mesh import make_mesh

    slopes, valid = _slopes()
    args = (torch.from_numpy(slopes), torch.from_numpy(valid))
    mesh = make_mesh(axis_name="boot", devices=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="n_replicates must be >= 2"):
        bootstrap.block_bootstrap_se(*args, n_replicates=1)
    with pytest.raises(ValueError, match="n_replicates must be >= 2"):
        bootstrap.block_bootstrap_se(*args, n_replicates=1, mesh=mesh)
    one = bootstrap.block_bootstrap_se(*args, n_replicates=200)
    sharded = bootstrap.block_bootstrap_se(*args, n_replicates=200, mesh=mesh)
    assert sharded.n_replicates == 200
    np.testing.assert_allclose(sharded.se.numpy(), one.se.numpy(), rtol=1e-8, atol=1e-12)


def test_cli_bootstrap_writes_the_table(tmp_path, capsys):
    out = tmp_path / "out"
    port_pipeline._main(["--synthetic", "--firms", "60", "--months", "72", "--device", "cpu",
                         "--bootstrap", "32", "--output-dir", str(out)])
    assert "bootstrap_table" in capsys.readouterr().out
    table = pd.read_pickle(out / "bootstrap_se.pkl")
    assert table.shape == (24, 12)
    assert list(table.columns.get_level_values(1)[:4]) == ["Slope", "Boot SE", "t (boot)",
                                                           "t (NW)"]
    assert "Boot SE" in (out / "bootstrap_se.tex").read_text()
