"""The port's firm-sharded Fama-MacBeth, replicate-sharded bootstrap and
mesh Table 2 / panel build vs the JAX package (``tests/test_parallel.py``).

The JAX side runs on a 4-device sub-mesh of the 8 virtual CPU devices of
``tests/conftest.py`` (8 for the device-count invariance case); the port on
meshes of repeated CPU devices, in float64. Pins are the reference's own:

- sharded FM vs the one-device Gram solve: slopes and R² at rtol 1e-7 /
  atol 1e-10 on valid months, coef 1e-7, t-stats 1e-6, month validity
  exact; vs the JAX sharded FM the same; vs the statsmodels-style oracle
  1e-6 / 1e-5; 8 shards vs 2 at 1e-9;
- near-singular months: distributed TSQR recovers one-device ``lstsq``
  (JAX's) within 1e-7 in the raw-row regime (R² 1e-6) where the Gram fast
  path visibly drifts, and within 5e-5 in the QR-compressed regime;
- float32 raw-unit columns: the sharded FM truncates a return-scale column
  at the QR cutoff ``eps·N`` exactly as JAX's sharded FM and one-device QR
  route do (each ~1 of scale off a float64 solve, the port within 1e-4 of
  JAX), while both Gram routes hold the float64 solve at 1e-5;
- the bootstrap on a mesh, given JAX's block starts, equals JAX's mesh
  bootstrap at 1e-8;
- Table 2 on a mesh: at least 95% of the formatted cells equal the JAX
  mesh table's and the port's one-device table's; the mesh panel build's
  vol/beta columns equal the one-device build's exactly (the daily stage
  has no collective) and JAX's at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu.ops.fama_macbeth import fama_macbeth as jax_fama_macbeth
from fm_returnprediction_tpu.ops.ols import monthly_cs_ols as jax_monthly_cs_ols
from fm_returnprediction_tpu.panel.dense import long_to_dense
from fm_returnprediction_tpu.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu.parallel import block_bootstrap_se as jax_block_se
from fm_returnprediction_tpu.parallel import fama_macbeth_sharded as jax_fm_sharded
from fm_returnprediction_tpu.parallel import make_mesh as jax_make_mesh
from fm_returnprediction_tpu.pipeline import build_panel as jax_build_panel
from fm_returnprediction_tpu.pipeline import build_panel_prepared as jax_build_prepared
from fm_returnprediction_tpu.reporting.table2 import build_table_2 as jax_build_table_2
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.parallel import bootstrap, fama_macbeth_sharded, make_mesh
from fm_returnprediction_tpu_torch.parallel.fm_sharded import monthly_cs_ols_sharded
from fm_returnprediction_tpu_torch.parallel.mesh import shard_panel
from fm_returnprediction_tpu_torch.pipeline import build_panel_prepared
from fm_returnprediction_tpu_torch.reporting.table2 import build_table_2

from oracle import make_synthetic_long_panel, oracle_fama_macbeth_summary, oracle_monthly_cs_ols
from test_torch_bootstrap import jax_starts

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _mesh(n=4, axis="firms"):
    return make_mesh(axis_name=axis, devices=[CPU] * n)


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(31)
    df, pred_cols = make_synthetic_long_panel(rng)
    dense = long_to_dense(df, "mthcaldt", "permno", ["retx"] + pred_cols)
    y, x, mask = dense.var("retx"), dense.select(pred_cols), dense.mask
    return df, pred_cols, (np.asarray(y), np.asarray(x), np.asarray(mask))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_sharded_fm_matches_single_chip_and_the_reference(panel):
    _, _, (y, x, mask) = panel
    cs_s, fm_s = fama_macbeth_sharded(*_t(y, x, mask), mesh=_mesh())
    cs_1, fm_1 = jax_fama_macbeth(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                                  solver="normal")
    _, fm_j = jax_fm_sharded(y, x, mask, mesh=jax_make_mesh(4, axis_name="firms"))
    np.testing.assert_array_equal(cs_s.month_valid.numpy(), np.asarray(cs_1.month_valid))
    valid = np.asarray(cs_1.month_valid)
    tol = dict(rtol=1e-7, atol=1e-10)
    _close(cs_s.slopes.numpy()[valid], np.asarray(cs_1.slopes)[valid], **tol)
    _close(cs_s.r2.numpy()[valid], np.asarray(cs_1.r2)[valid], **tol)
    for fm in (fm_1, fm_j):
        _close(fm_s.coef, fm.coef, **tol)
        _close(fm_s.tstat, fm.tstat, rtol=1e-6, atol=1e-9)


def test_sharded_fm_matches_oracle(panel):
    df, pred_cols, (y, x, mask) = panel
    _, fm_s = fama_macbeth_sharded(*_t(y, x, mask), mesh=_mesh())
    want = oracle_fama_macbeth_summary(oracle_monthly_cs_ols(df, "retx", pred_cols), pred_cols)
    for i, col in enumerate(pred_cols):
        _close(fm_s.coef[i], want[f"{col}_coef"], rtol=1e-6, atol=1e-9)
        _close(fm_s.tstat[i], want[f"{col}_tstat"], rtol=1e-5, atol=1e-8)


def test_sharded_fm_subset_mesh(panel):
    """A 2-shard mesh gives the 8-shard answers (device-count invariance)."""
    _, _, (y, x, mask) = panel
    _, fm8 = fama_macbeth_sharded(*_t(y, x, mask), mesh=_mesh(8))
    _, fm2 = fama_macbeth_sharded(*_t(y, x, mask), mesh=_mesh(2))
    _close(fm8.coef, fm2.coef, rtol=1e-9, atol=1e-12)


def test_bootstrap_sharded_matches_the_reference_mesh():
    """Same starts (JAX's keys), same replicate set: the port's mesh route
    equals JAX's mesh bootstrap and its own one-device route."""
    rng = np.random.default_rng(99)
    t, p = 240, 3
    eps = rng.standard_normal((t, p))
    s = np.zeros((t, p))
    for i in range(1, t):
        s[i] = 0.3 * s[i - 1] + eps[i]
    valid = rng.random((t, p)) > 0.1
    b = 512
    jmesh = jax_make_mesh(4, axis_name="boot")
    want = jax_block_se(jnp.asarray(s), jnp.asarray(valid), jax.random.key(0), n_replicates=b,
                        mesh=jmesh)
    starts = jax_starts(0, valid.sum(axis=0), b, 5, t)
    orig = bootstrap.draw_block_starts
    bootstrap.draw_block_starts = lambda counts, n, bl, tt, generator: starts
    try:
        got = bootstrap.block_bootstrap_se(*_t(s, valid), n_replicates=b, mesh=_mesh(4, "boot"))
        one = bootstrap.block_bootstrap_se(*_t(s, valid), n_replicates=b)
    finally:
        bootstrap.draw_block_starts = orig
    assert got.n_replicates == want.n_replicates == b
    _close(got.se, want.se, rtol=1e-8, atol=1e-12)
    _close(got.se, one.se, rtol=1e-8, atol=1e-12)


def _near_singular(t, n, p, cond, seed, mask_rows):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((t, n, 1))
    x = np.repeat(base, p, axis=2) + rng.standard_normal((t, n, p)) / cond
    beta = rng.standard_normal(p)
    y = x @ beta + 0.01 * rng.standard_normal((t, n))
    mask = np.zeros((t, n), dtype=bool)
    for i in range(t):
        mask[i, rng.choice(n, size=mask_rows, replace=False)] = True
    return np.where(mask, y, np.nan), x, mask


@pytest.mark.parametrize("regime", ["raw_rows", "qr_compressed"])
def test_tsqr_recovers_lstsq_on_near_singular_months(regime):
    """``test_sharded_refinement_recovers_lstsq_on_near_singular_months`` and
    ``test_sharded_tsqr_compressed_regime_near_singular``."""
    y, x, mask = _near_singular(*((24, 48) if regime == "raw_rows" else (12, 512)), 6, 1e6, 5, 7)
    mesh = _mesh(8)
    cs_svd = jax_monthly_cs_ols(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                                solver="lstsq")
    placed = shard_panel(*_t(y, x, mask), mesh)
    valid = np.asarray(cs_svd.month_valid)
    want = np.asarray(cs_svd.slopes)[valid]
    assert valid.any()

    def drift(cs):
        return np.max(np.abs(cs.slopes.numpy()[valid] - want) / np.maximum(np.abs(want), 1.0))

    cs_ref = monthly_cs_ols_sharded(*placed, mesh, n_refine=2)
    if regime == "raw_rows":
        cs_raw = monthly_cs_ols_sharded(*placed, mesh, n_refine=0)
        assert drift(cs_ref) < 1e-7, drift(cs_ref)
        assert drift(cs_raw) > 10 * max(drift(cs_ref), 1e-12)
        _close(cs_ref.r2.numpy()[valid], np.asarray(cs_svd.r2)[valid], rtol=1e-6, atol=1e-8)
    else:
        assert placed[0].shards[0].shape[1] > 6 + 2, "the fixture must take the QR branch"
        assert drift(cs_ref) < 5e-5, drift(cs_ref)


def _held_gap(got, want, se):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), np.asarray(se, float))))


def test_f32_sharded_fm_truncates_raw_unit_columns_as_the_reference_does():
    """At float32 the distributed TSQR solve keeps singular values down to
    ``rcond = eps·N`` of the largest, the one-device QR solver's cutoff. A
    raw-unit column (a size in thousands) beside a return-scale column
    (std 0.05) puts the latter's singular value under that cutoff, so both
    packages' sharded FM and JAX's one-device QR route drop it, ~1 of
    ``max(|b|, nw_se)`` from a float64 solve, while both packages' Gram
    routes (the spec grid: Table 2's unsharded route) hold that solve. The
    port's sharded FM stays within 1e-4 of JAX's."""
    from fm_returnprediction_tpu.specgrid import Spec as JaxSpec
    from fm_returnprediction_tpu.specgrid import SpecGrid as JaxSpecGrid
    from fm_returnprediction_tpu.specgrid import run_spec_grid as jax_run_spec_grid
    from fm_returnprediction_tpu_torch.specgrid import Spec, SpecGrid, run_spec_grid

    rng = np.random.default_rng(5)
    t, n = 60, 512
    size = 1e3 * np.exp(rng.standard_normal((t, n)))
    ret = 0.05 * rng.standard_normal((t, n))
    bm = rng.standard_normal((t, n))
    x = np.stack([size, ret, bm], -1)
    y = 1e-9 * size + 0.3 * ret + 0.01 * bm + 0.1 * rng.standard_normal((t, n))
    mask = rng.random((t, n)) > 0.1
    y = np.where(mask, y, np.nan)
    y32, x32 = y.astype(np.float32), x.astype(np.float32)
    _, truth = jax_fama_macbeth(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                                solver="lstsq")
    se = np.asarray(truth.nw_se)
    jy, jx, jm = jnp.asarray(y32), jnp.asarray(x32), jnp.asarray(mask)
    _, fm_j = jax_fm_sharded(jy, jx, jm, mesh=jax_make_mesh(4, axis_name="firms"))
    _, qr_j = jax_fama_macbeth(jy, jx, jm, solver="qr")
    _, fm_p = fama_macbeth_sharded(*_t(y32, x32, mask), mesh=_mesh())
    names = ("size", "ret", "bm")
    gram_j = jax_run_spec_grid(jy, jx, {"all": jm},
                               JaxSpecGrid((JaxSpec("m", names, "all"),))).coef[0]
    gram_p = run_spec_grid(*_t(y32, x32), {"all": torch.from_numpy(mask)},
                           SpecGrid((Spec("m", names, "all"),))).coef[0]
    for truncated in (fm_j.coef, qr_j.coef, fm_p.coef):
        assert _held_gap(truncated, truth.coef, se) > 0.5
    for gram in (gram_j, gram_p):
        assert _held_gap(gram, truth.coef, se) < 1e-5
    assert _held_gap(fm_p.coef, fm_j.coef, fm_j.nw_se) < 1e-4
    tj = np.asarray(fm_j.tstat, float)
    assert np.max(np.abs(fm_p.tstat.numpy() - tj) / np.maximum(np.abs(tj), 1.0)) < 1e-4


@pytest.fixture(scope="module")
def reporting_panels():
    capture = {}
    data = generate_synthetic_wrds(SyntheticConfig(n_firms=50, n_months=80))
    jax_build_panel(data, dtype=np.float64, capture=capture)
    jp, factors = jax_build_prepared(capture["dense_base"], capture["compact_daily"],
                                     dtype=np.float64)
    masks = compute_subset_masks(jp)
    pp = DensePanel(values=torch.from_numpy(np.array(jp.values)), mask=np.asarray(jp.mask),
                    months=np.asarray(jp.months), ids=np.asarray(jp.ids),
                    var_names=list(jp.var_names))
    pmasks = {k: torch.from_numpy(np.array(m)) for k, m in masks.items()}
    return capture, jp, masks, pp, pmasks, factors


def test_table2_mesh_matches_single_device(reporting_panels):
    _, jp, masks, pp, pmasks, factors = reporting_panels
    got = build_table_2(pp, pmasks, factors, mesh=_mesh())
    for want in (build_table_2(pp, pmasks, factors),
                 jax_build_table_2(jp, masks, factors, mesh=jax_make_mesh(4, axis_name="firms"))):
        a = got.to_numpy().astype(str).ravel()
        b = want.to_numpy().astype(str).ravel()
        assert got.shape == want.shape and (a == b).mean() > 0.95


def test_build_panel_mesh_daily_stage_matches_single_device(reporting_panels):
    from fm_returnprediction_tpu_torch.convert import prepared_from_numpy

    capture, jp, _, _, _, _ = reporting_panels
    args = prepared_from_numpy(capture["dense_base"], capture["compact_daily"])
    one, _ = build_panel_prepared(*args, dtype=torch.float64, device="cpu")
    meshed, _ = build_panel_prepared(*args, dtype=torch.float64, device="cpu", mesh=_mesh())
    for col in ("rolling_std_252", "beta"):
        a, b = one.var(col).numpy(), meshed.var(col).numpy()
        np.testing.assert_array_equal(a, b, err_msg=col)
        np.testing.assert_allclose(b, np.asarray(jp.var(col)), rtol=1e-12, atol=1e-12,
                                   equal_nan=True, err_msg=col)
