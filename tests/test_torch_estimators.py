"""The estimator family, the port vs the JAX package on the CPU.

The JAX package's own fixtures (``tests/test_estimators.py``: ``panel``
18 months × 60 firms × 5 columns, ``grid_panel`` 30 × 50 × 4) go through
both packages at float64, JAX under x64 on its XLA contraction. Every
transform (FWL, IV, the FE cell contraction and the alternating
projections one- and two-way, the pooled fit under its five SE families,
the clustered FM tail) and every route (the estimator grid per kind, the
tile engine, the bank's estimator queries, the streaming bootstrap, the
pipeline and its command line) is held against the JAX function at 1e-10
of ``max(|value|, 1)``; NaN patterns, month counts and the integer
disclosures (``deficient_months``, ``absorb_iters``, ``absorb_converged``)
exactly. The reference's host oracles (explicit controls, closed-form
2SLS, dummy-variable OLS, the numpy sandwich) are checked on the port at
the reference's own pins. Also here: the factorized and per-spec
contraction plans, the coreset row weights, the engine's loud validations,
the K2 width cap, the leaked-estimator guard of Table 2 and the figure
sweep, ``rolling_fm_windows``, and the GPU default of each new entry point.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.ops.compaction import rolling_over_valid_rows as jax_rolling_rows
from fm_returnprediction_tpu.ops.newey_west import clustered_mean_se as jax_clustered_se
from fm_returnprediction_tpu.specgrid import estimators as jest
from fm_returnprediction_tpu.specgrid import grambank as jax_grambank
from fm_returnprediction_tpu.specgrid.boot import rolling_fm_windows as jax_rolling_fm_windows
from fm_returnprediction_tpu.specgrid.cellspace import CellSpace as JaxCellSpace
from fm_returnprediction_tpu.specgrid.engine import run_cellspace as jax_run_cellspace
from fm_returnprediction_tpu.specgrid.estimators import absorb as jax_absorb
from fm_returnprediction_tpu.specgrid.estimators import cluster as jax_cluster
from fm_returnprediction_tpu.specgrid.estimators import fwl as jax_fwl
from fm_returnprediction_tpu.specgrid.estimators import iv as jax_iv
from fm_returnprediction_tpu.specgrid.grams import contract_spec_grams as jax_contract
from fm_returnprediction_tpu.specgrid.solve import run_spec_grid_weights as jax_grid_weights
from fm_returnprediction_tpu.specgrid.solve import solve_spec_stats as jax_solve
from fm_returnprediction_tpu.specgrid.specs import Spec as JaxSpec
from fm_returnprediction_tpu.specgrid.specs import SpecGrid as JaxSpecGrid
from fm_returnprediction_tpu_torch.ops.compaction import rolling_over_valid_rows
from fm_returnprediction_tpu_torch.ops.newey_west import clustered_mean_se, clustered_mean_se_np
from fm_returnprediction_tpu_torch.specgrid import boot, grambank, scenarios
from fm_returnprediction_tpu_torch.specgrid.cellspace import CellSpace
from fm_returnprediction_tpu_torch.specgrid.engine import run_cellspace
from fm_returnprediction_tpu_torch.specgrid.estimators import (
    EST_OLS,
    Estimator,
    StreamingBootstrap,
    parse_estimator,
    resolve_estimator,
    run_estimator_grid_weights,
)
from fm_returnprediction_tpu_torch.specgrid.estimators.absorb import (
    absorb_transform,
    contract_absorb_cells,
)
from fm_returnprediction_tpu_torch.specgrid.estimators.cluster import pooled_fit
from fm_returnprediction_tpu_torch.specgrid.estimators.fwl import fwl_transform
from fm_returnprediction_tpu_torch.specgrid.estimators.iv import iv_r2, iv_transform
from fm_returnprediction_tpu_torch.specgrid.grams import contract_spec_grams
from fm_returnprediction_tpu_torch.specgrid.solve import (
    contraction_counts,
    run_spec_grid_weights,
    solve_spec_stats,
)
from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid

pytestmark = pytest.mark.torch_port

CPU = "cpu"
TOL = 1e-10
EPS64 = float(np.finfo(np.float64).eps)
REPO = Path(__file__).resolve().parents[1]
POOLED_SE = ("iid", "white", "cluster_month", "cluster_firm", "cluster_twoway")


# ---------------------------------------------------------------- helpers
def _t(a, dtype=None):
    out = torch.as_tensor(np.asarray(a))
    return out if dtype is None else out.to(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(got, want, what="", tol=TOL):
    """``got`` within ``tol`` of ``max(|want|, 1)``, NaN patterns equal."""
    g, w = _np(got).astype(float), _np(want).astype(float)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    fin = np.isfinite(w)
    if fin.any():
        gap = np.abs(g[fin] - w[fin]) / np.maximum(np.abs(w[fin]), 1.0)
        assert gap.max() <= tol, (what, float(gap.max()))


def _stats_close(got, want, what=""):
    for name, g, w in zip(("gram", "moment", "n", "ysum", "yy", "center"), got, want):
        _close(g, w, f"{what} {name}")


def _results_close(got, want, what=""):
    """Two per-weight SpecGridResult dicts: floats at TOL, counts exact."""
    assert set(got) == set(want)
    for w in want:
        g, r = got[w], want[w]
        for name in ("slopes", "intercept", "r2", "n_obs", "coef", "tstat", "nw_se",
                     "mean_r2", "mean_n"):
            _close(getattr(g, name), getattr(r, name), f"{what} {w} {name}")
        for name in ("month_valid", "n_months", "suspect_months"):
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(r, name)),
                                          err_msg=f"{what} {w} {name}")
        assert tuple(g.referee_specs) == tuple(r.referee_specs) == ()


def _disclosures_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _frames_close(got: pd.DataFrame, want: pd.DataFrame, what="", tol=TOL):
    assert list(got.columns) == list(want.columns), (what, list(got.columns),
                                                     list(want.columns))
    assert len(got) == len(want) > 0, what
    for c in want.columns:
        if want[c].dtype.kind == "f":
            _close(got[c].to_numpy(float), want[c].to_numpy(float), f"{what} {c}", tol)
        else:
            g, w = got[c].reset_index(drop=True), want[c].reset_index(drop=True)
            assert g.equals(w), (what, c, g[g != w].head(), w[g != w].head())


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def panel():
    """(T, N, P=5) panel with NaN holes — the transform-level shape."""
    rng = np.random.default_rng(7)
    t, n, p = 18, 60, 5
    y = rng.normal(size=(t, n))
    x = rng.normal(size=(t, n, p))
    x[rng.random((t, n, p)) < 0.03] = np.nan
    y[rng.random((t, n)) < 0.02] = np.nan
    uni = np.ones((1, t, n), bool)
    window = np.ones((1, t), bool)
    return y, x, uni, window


def _both_stats(panel, col):
    """The same contraction in both packages: (port stats, JAX stats)."""
    y, x, uni, window = panel
    port = contract_spec_grams(_t(y), _t(x), _t(uni), torch.zeros(1, dtype=torch.long),
                               _t(col), _t(window))
    ref = jax_contract(jnp.asarray(y), jnp.asarray(x), jnp.asarray(uni), jnp.zeros(1, int),
                       jnp.asarray(col), jnp.asarray(window))
    _stats_close(port, ref, "contraction")
    return port, ref


@pytest.fixture(scope="module")
def grid_panel():
    """Grid-level panel: named columns, one universe, a window spec."""
    rng = np.random.default_rng(11)
    t, n, p = 30, 50, 4
    names = ("a", "b", "c", "z")
    y = rng.normal(size=(t, n))
    x = rng.normal(size=(t, n, p))
    x[rng.random((t, n, p)) < 0.03] = np.nan
    masks = {"all": np.ones((t, n), bool)}
    specs = (("s0", ("a",), None), ("s1", ("a", "b"), None), ("s2", ("a", "b"), (5, 25)))
    grid = SpecGrid(specs=tuple(Spec(nm, c, "all", window=w) for nm, c, w in specs),
                    union=names)
    jgrid = JaxSpecGrid(specs=tuple(JaxSpec(nm, c, "all", window=w) for nm, c, w in specs),
                        union=names)
    return y, x, masks, grid, jgrid, names


def _port_grid(est, grid_panel, **kw):
    y, x, masks, grid, _, _ = grid_panel
    return run_estimator_grid_weights(parse_estimator(est) if isinstance(est, str) else est,
                                      _t(y), _t(x), {k: _t(m) for k, m in masks.items()},
                                      grid, ("reference",), **kw)


def _jax_grid(est, grid_panel, **kw):
    y, x, masks, _, jgrid, _ = grid_panel
    return jest.run_estimator_grid_weights(jest.parse_estimator(est), y, x, masks, jgrid,
                                           ("reference",), **kw)


def _ols_host(yv, xv):
    xa = np.column_stack([np.ones(len(yv)), xv])
    b, *_ = np.linalg.lstsq(xa, yv, rcond=None)
    return b


# ------------------------------------------------------------ spec grammar
def test_parse_grammar_round_trips():
    for text in ("ols", "fwl:c1+c2@iid", "absorb:ind+size", "iv:beme~z1+z2",
                 "pooled:cluster_month", "pooled", "fwl:c@cluster", "ols@iid"):
        got, want = parse_estimator(text), jest.parse_estimator(text)
        assert (got.kind, got.controls, got.absorb, got.endog, got.instruments, got.se,
                got.label) == (want.kind, want.controls, want.absorb, want.endog,
                               want.instruments, want.se, want.label), text
    assert parse_estimator("ols") == EST_OLS
    assert parse_estimator("pooled").se == "iid"


@pytest.mark.parametrize("bad", ["fwl", "iv:b", "pooled:cluster_galaxy", "fwl:c@cluster_month",
                                 "ridge:0.1"])
def test_parse_rejects_bad_grammar(bad):
    with pytest.raises(ValueError):
        jest.parse_estimator(bad)
    with pytest.raises(ValueError):
        parse_estimator(bad)


def test_resolve_env_knob_and_loud_allowed(monkeypatch):
    monkeypatch.delenv("FMRP_SPECGRID_ESTIMATOR", raising=False)
    assert resolve_estimator(None) == EST_OLS
    monkeypatch.setenv("FMRP_SPECGRID_ESTIMATOR", "fwl:beme@iid")
    assert resolve_estimator(None).label == jest.resolve_estimator(None).label == "fwl[beme]"
    assert resolve_estimator("iv:b~z").kind == "iv"
    for resolve in (resolve_estimator, jest.resolve_estimator):
        with pytest.raises(ValueError, match="ols"):
            resolve(None, allowed=("ols",))
    monkeypatch.delenv("FMRP_SPECGRID_ESTIMATOR", raising=False)
    with pytest.raises(TypeError):
        resolve_estimator(123)


# --------------------------------- the leaked-estimator guard (the fault)
@pytest.mark.parametrize("surface", ["subset_sweep", "table_2_cells", "build_table_2"])
def test_reporting_surfaces_reject_leaked_estimator(surface, monkeypatch):
    """Table 2 and the figure sweep resolve the knob with
    ``allowed=("ols",)`` before any compute: a leaked non-OLS estimator
    raises ValueError naming ``ols`` and the panel argument is never
    touched (``None`` here), as in the reference."""
    from fm_returnprediction_tpu.reporting import figure1 as jax_figure1
    from fm_returnprediction_tpu_torch.reporting import figure1, table2

    monkeypatch.setenv("FMRP_SPECGRID_ESTIMATOR", "pooled:cluster_month")
    if surface == "subset_sweep":
        calls = [lambda: figure1.subset_sweep(None, {"All stocks": None}, ["All stocks"]),
                 lambda: jax_figure1.subset_sweep(None, {"All stocks": None}, ["All stocks"])]
    else:
        # the reference reads the panel before its Table 2 guard, so only the
        # port's Table 2 takes a None panel (the pipeline test below holds
        # both packages' Table 2 to the guard)
        calls = [lambda: getattr(table2, surface)(None, {"All stocks": None}, {})]
    for call in calls:
        with pytest.raises(ValueError, match="ols"):
            call()


def test_pipeline_stops_at_table_2_on_a_leaked_estimator(monkeypatch):
    """With ``FMRP_SPECGRID_ESTIMATOR`` set to a non-OLS kind, the port's
    ``run_pipeline`` and the reference's both raise ValueError in Table
    2's module, before any later stage."""
    from fm_returnprediction_tpu import pipeline as jax_pipeline
    from fm_returnprediction_tpu.data.synthetic import SyntheticConfig as JaxConfig
    from fm_returnprediction_tpu_torch import pipeline as port_pipeline
    from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig

    monkeypatch.setenv("FMRP_SPECGRID_ESTIMATOR", "iv:log_size~log_bm")
    runs = [(lambda: port_pipeline.run_pipeline(
                synthetic=True, synthetic_config=SyntheticConfig(n_firms=40, n_months=48),
                device=CPU, make_specgrid=True), "fm_returnprediction_tpu_torch"),
            (lambda: jax_pipeline.run_pipeline(
                synthetic=True, synthetic_config=JaxConfig(n_firms=40, n_months=48),
                make_specgrid=True), "fm_returnprediction_tpu")]
    for run, package in runs:
        with pytest.raises(ValueError, match="ols") as exc:
            run()
        files = [str(entry.path) for entry in exc.traceback]
        assert any(f.endswith(os.path.join(package, "reporting", "table2.py"))
                   for f in files), files


# ------------------------------------------------- FWL: exact Schur parity
def test_fwl_transform_equals_explicit_controls(panel):
    y, x, _, _ = panel
    t, _, p = x.shape
    col_full = np.ones((1, p), bool)
    ctrl = np.zeros(p, bool)
    ctrl[3:] = True
    stats, ref = _both_stats(panel, col_full)
    sel_aug = np.concatenate([[[True]], col_full & ~ctrl], axis=1)
    ctrl_aug = np.concatenate([[[True]], ctrl[None]], axis=1)
    full_aug = np.concatenate([[[True]], col_full], axis=1)
    st2, deficient = fwl_transform(stats, _t(full_aug), _t(ctrl_aug), EPS64)
    st2_ref, deficient_ref = jax_fwl.fwl_transform(ref, jnp.asarray(full_aug),
                                                   jnp.asarray(ctrl_aug), EPS64)
    _stats_close(st2, st2_ref, "fwl stats")
    np.testing.assert_array_equal(_np(deficient), np.asarray(deficient_ref))
    beta = _np(solve_spec_stats(st2, _t(sel_aug))[0].beta)[0]
    _close(beta, np.asarray(jax_solve(st2_ref, jnp.asarray(sel_aug)).beta)[0], "fwl beta")
    errs = []
    for m in range(t):
        rows = np.isfinite(y[m]) & np.all(np.isfinite(x[m]), axis=-1)
        if rows.sum() < p + 1:
            continue
        b_full = _ols_host(y[m, rows], x[m, rows])
        errs.append(np.abs(beta[m, 1:][~ctrl] - b_full[1:][~ctrl]).max())
    assert errs and max(errs) < 1e-8
    assert not _np(deficient).any()


def test_fwl_grid_vs_explicit_controls(grid_panel):
    y, x, masks, _, _, names = grid_panel
    res, disc = _port_grid("fwl:c", grid_panel)
    res_ref, disc_ref = _jax_grid("fwl:c", grid_panel)
    _results_close(res, res_ref, "fwl grid")
    _disclosures_equal(disc, disc_ref)
    assert disc["kind"] == "fwl" and disc["estimator"] == "fwl[c]"
    grid_ctrl = SpecGrid(specs=(Spec("s0", ("a", "c"), "all"), Spec("s1", ("a", "b", "c"), "all"),
                                Spec("s2", ("a", "b", "c"), "all", window=(5, 25))), union=names)
    full = run_spec_grid_weights(_t(y), _t(x), {k: _t(m) for k, m in masks.items()}, grid_ctrl,
                                 ("reference",), referee=False)["reference"]
    r = res["reference"]
    assert np.nanmax(np.abs(r.slopes[:, :, :2] - full.slopes[:, :, :2])) < 1e-10
    assert np.nanmax(np.abs(r.coef[:, :2] - full.coef[:, :2])) < 1e-10


# --------------------------------------------------------- IV: 2SLS parity
def test_iv_vs_closed_form_2sls(panel):
    y, x, _, _ = panel
    t, _, p = x.shape
    col_iv = np.zeros((1, p), bool)
    col_iv[0, :2] = True                      # structural: 1 + x0 + x1
    inst = np.zeros(p, bool)
    inst[3:] = True                           # excluded instruments: x3, x4
    endog = np.zeros(p, bool)
    endog[1] = True                           # x1 endogenous
    col_eff = col_iv | inst[None]
    stats, ref = _both_stats(panel, col_eff)
    sel_aug = np.concatenate([[[True]], col_iv], axis=1)
    z_aug = np.concatenate([[[True]], (col_iv & ~endog[None]) | inst[None]], axis=1)
    st_iv, deficient = iv_transform(stats, _t(sel_aug), _t(z_aug), EPS64)
    st_ref, deficient_ref = jax_iv.iv_transform(ref, jnp.asarray(sel_aug), jnp.asarray(z_aug),
                                                EPS64)
    _stats_close(st_iv, st_ref, "iv stats")
    np.testing.assert_array_equal(_np(deficient), np.asarray(deficient_ref))
    sol = solve_spec_stats(st_iv, _t(sel_aug))[0]
    sol_ref = jax_solve(st_ref, jnp.asarray(sel_aug))
    r2 = _np(iv_r2(sol.beta, stats, sol.month_valid))
    _close(r2, np.asarray(jax_iv.iv_r2(sol_ref.beta, ref, sol_ref.month_valid)), "iv r2")
    beta = _np(sol.beta)[0]
    _close(beta, np.asarray(sol_ref.beta)[0], "iv beta")
    errs_b, errs_r2 = [], []
    for m in range(t):
        rows = np.isfinite(y[m]) & np.all(np.isfinite(x[m][:, col_eff[0]]), axis=-1)
        if rows.sum() < 5:
            continue
        yv = y[m, rows]
        big_x = np.column_stack([np.ones(rows.sum()), x[m, rows][:, :2]])
        big_z = np.column_stack([np.ones(rows.sum()), x[m, rows][:, 0], x[m, rows][:, 3:]])
        pz = big_z @ np.linalg.pinv(big_z.T @ big_z) @ big_z.T
        xh = pz @ big_x
        b2sls = np.linalg.pinv(xh.T @ big_x) @ (xh.T @ yv)
        errs_b.append(np.abs(beta[m, :3] - b2sls).max())
        u = yv - big_x @ b2sls
        errs_r2.append(abs(float(r2[0, m]) - (1 - (u @ u) / ((yv - yv.mean()) ** 2).sum())))
    assert errs_b and max(errs_b) < 1e-8
    assert max(errs_r2) < 1e-8


# ----------------------------------------- absorbed FE vs dummy-OLS oracle
def _absorb_both(panel, col, codes_a, codes_b, ga, gb, n_fe, tol, max_iter):
    y, x, uni, window = panel
    stats, ref = _both_stats(panel, col)
    sel_aug = np.concatenate([[[True]], col], axis=1)
    nc, sc = contract_absorb_cells(_t(y), _t(x), _t(uni), torch.zeros(1, dtype=torch.long),
                                   _t(col), _t(window), stats.center, _t(codes_a), _t(codes_b),
                                   ga=ga, gb=gb)
    nc_ref, sc_ref = jax_absorb.contract_absorb_cells(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(uni), jnp.zeros(1, int), jnp.asarray(col),
        jnp.asarray(window), ref.center, jnp.asarray(codes_a, jnp.int32),
        jnp.asarray(codes_b, jnp.int32), ga=ga, gb=gb)
    _close(nc, nc_ref, "n_cells")
    _close(sc, sc_ref, "s_cells")
    st, iters, delta = absorb_transform(stats, _t(sel_aug), nc, sc, n_fe=n_fe, tol=tol,
                                        max_iter=max_iter)
    st_ref, iters_ref, delta_ref = jax_absorb.absorb_transform(
        ref, jnp.asarray(sel_aug), nc_ref, sc_ref, n_fe=n_fe, tol=tol, max_iter=max_iter)
    _stats_close(st, st_ref, "absorb stats")
    np.testing.assert_array_equal(_np(iters), np.asarray(iters_ref))
    _close(delta, delta_ref, "absorb delta")
    beta = _np(solve_spec_stats(st, _t(sel_aug))[0].beta)[0]
    _close(beta, np.asarray(jax_solve(st_ref, jnp.asarray(sel_aug)).beta)[0], "absorb beta")
    return beta, _np(iters), _np(delta)


def test_absorb_oneway_vs_dummy_ols(panel):
    y, x, _, _ = panel
    t, n, p = x.shape
    ga = 4
    codes = np.random.default_rng(70).integers(0, ga, size=(t, n))
    col = np.zeros((1, p), bool)
    col[0, :3] = True
    beta, iters, _ = _absorb_both(panel, col, codes, np.zeros((t, n), np.int64), ga, 1, 1,
                                  1e-12, 50)
    errs = []
    for m in range(t):
        rows = np.isfinite(y[m]) & np.all(np.isfinite(x[m][:, :3]), axis=-1)
        pres = np.unique(codes[m, rows])
        if rows.sum() < 3 + len(pres):
            continue
        dummies = (codes[m, rows][:, None] == pres[None, :]).astype(float)
        b, *_ = np.linalg.lstsq(np.column_stack([x[m, rows][:, :3], dummies]), y[m, rows],
                                rcond=None)
        errs.append(np.abs(beta[m, 1:4] - b[:3]).max())
    assert errs and max(errs) < 1e-8
    assert int(iters.max()) <= 2


def test_absorb_twoway_vs_dummy_ols(panel):
    y, x, _, _ = panel
    t, n, p = x.shape
    rng = np.random.default_rng(71)
    ga, gb = 4, 3
    codes_a = rng.integers(0, ga, size=(t, n))
    codes_b = rng.integers(0, gb, size=(t, n))
    col = np.zeros((1, p), bool)
    col[0, :3] = True
    beta, iters, delta = _absorb_both(panel, col, codes_a, codes_b, ga, gb, 2, 1e-13, 200)
    errs = []
    for m in range(t):
        rows = np.isfinite(y[m]) & np.all(np.isfinite(x[m][:, :3]), axis=-1)
        pa, pb = np.unique(codes_a[m, rows]), np.unique(codes_b[m, rows])
        if rows.sum() < 3 + len(pa) + len(pb):
            continue
        da = (codes_a[m, rows][:, None] == pa[None, :]).astype(float)
        db = (codes_b[m, rows][:, None] == pb[None, :]).astype(float)
        b, *_ = np.linalg.lstsq(np.column_stack([x[m, rows][:, :3], da, db[:, 1:]]),
                                y[m, rows], rcond=None)
        errs.append(np.abs(beta[m, 1:4] - b[:3]).max())
    assert errs and max(errs) < 1e-7
    assert 1 < int(iters.max()) < 200
    assert float(delta.max()) < 1e-10


@pytest.mark.parametrize("fe", ["ind", "ind+size"])
def test_absorb_grid_disclosure(grid_panel, fe):
    y = grid_panel[0]
    rng = np.random.default_rng(72)
    fe_codes = {"ind": rng.integers(0, 3, size=y.shape), "size": rng.integers(0, 4, size=y.shape)}
    res, disc = _port_grid(f"absorb:{fe}", grid_panel, fe_codes=fe_codes)
    res_ref, disc_ref = _jax_grid(f"absorb:{fe}", grid_panel, fe_codes=fe_codes)
    _results_close(res, res_ref, f"absorb {fe}")
    _disclosures_equal(disc, disc_ref)
    assert np.asarray(disc["absorb_converged"]).all()
    assert int(np.asarray(disc["absorb_iters"]).max()) >= 1
    assert np.isfinite(res["reference"].coef[1, :2]).all()


# --------------------------------------- pooled sandwich SEs vs numpy oracle
@pytest.mark.parametrize("se_kind", POOLED_SE)
def test_pooled_sandwich_vs_host_oracle(panel, se_kind):
    y, x, uni, window = panel
    t, _, p = x.shape
    col = np.zeros((1, p), bool)
    col[0, :3] = True
    stats, ref = _both_stats(panel, col)
    sel_aug = np.concatenate([[[True]], col], axis=1)
    rows3 = np.isfinite(y) & np.all(np.isfinite(x[:, :, :3]), axis=-1)
    ys, xs, tids, fids = [], [], [], []
    for m in range(t):
        r = rows3[m]
        ys.append(y[m, r])
        xs.append(x[m, r][:, :3])
        tids.append(np.full(r.sum(), m))
        fids.append(np.flatnonzero(r))
    yv = np.concatenate(ys)
    xa = np.column_stack([np.ones(len(yv)), np.concatenate(xs)])
    tid, fid = np.concatenate(tids), np.concatenate(fids)
    bread = np.linalg.pinv(xa.T @ xa)
    bh = bread @ (xa.T @ yv)
    uh = yv - xa @ bh

    res = pooled_fit(stats, _t(sel_aug), se_kind, EPS64,
                     panel=(_t(y), _t(x), _t(uni), torch.zeros(1, dtype=torch.long), _t(col),
                            _t(window)))
    want = jax_cluster.pooled_fit(ref, jnp.asarray(sel_aug), se_kind, EPS64, panel=(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(uni), jnp.zeros(1, int), jnp.asarray(col),
        jnp.asarray(window)))
    for name in ("beta", "se", "tstat", "r2", "n_total"):
        _close(getattr(res, name), getattr(want, name), f"pooled {se_kind} {name}")
    for name in ("n_months", "deficient"):
        np.testing.assert_array_equal(_np(getattr(res, name)), np.asarray(getattr(want, name)))
    assert np.abs(_np(res.beta)[0][:4] - bh).max() < 1e-8

    if se_kind == "iid":
        v = (uh @ uh / (len(yv) - 4)) * bread
    else:
        def meat_by(ids):
            meat = np.zeros((4, 4))
            for g in np.unique(ids):
                s = (xa[ids == g] * uh[ids == g, None]).sum(0)
                meat += np.outer(s, s)
            return meat

        mw = (xa * (uh ** 2)[:, None]).T @ xa
        meat = {"white": mw, "cluster_month": meat_by(tid), "cluster_firm": meat_by(fid),
                "cluster_twoway": meat_by(tid) + meat_by(fid) - mw}[se_kind]
        v = bread @ meat @ bread
    assert np.abs(_np(res.se)[0][:4] - np.sqrt(np.diag(v))).max() < 1e-8


def test_pooled_month_separable_needs_no_panel(panel):
    x = panel[1]
    col = np.zeros((1, x.shape[-1]), bool)
    col[0, :3] = True
    stats, ref = _both_stats(panel, col)
    sel_aug = np.concatenate([[[True]], col], axis=1)
    res = pooled_fit(stats, _t(sel_aug), "cluster_month", EPS64, panel=None)
    want = jax_cluster.pooled_fit(ref, jnp.asarray(sel_aug), "cluster_month", EPS64, panel=None)
    _close(res.se, want.se, "pooled cluster_month se")
    assert np.isfinite(_np(res.se)[0][:4]).all()
    with pytest.raises(ValueError, match="panel"):
        pooled_fit(stats, _t(sel_aug), "cluster_firm", EPS64, panel=None)


def test_clustered_mean_se_vs_np_oracle():
    rng = np.random.default_rng(12)
    t = 120
    x = rng.standard_normal(t)
    valid = rng.random(t) > 0.1
    clusters = rng.integers(0, 10, size=t)
    se = float(clustered_mean_se(_t(x), _t(valid), _t(clusters)))
    se_ref = float(jax_clustered_se(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(clusters)))
    assert abs(se - se_ref) <= 1e-12 * max(abs(se_ref), 1.0)
    np.testing.assert_allclose(se, clustered_mean_se_np(x[valid], clusters[valid]), atol=1e-12)
    # batched over leading axes, each series its own mean
    xs = rng.standard_normal((3, t))
    vs = rng.random((3, t)) > 0.2
    got = _np(clustered_mean_se(_t(xs), _t(vs), _t(clusters)))
    for i in range(3):
        np.testing.assert_allclose(got[i], clustered_mean_se_np(xs[i][vs[i]],
                                                                clusters[vs[i]]), atol=1e-12)
    one = np.zeros(t, bool)
    one[3] = True
    assert np.isnan(float(clustered_mean_se(_t(x), _t(one), _t(clusters))))


@pytest.mark.parametrize("se", ["iid", "cluster"])
def test_fm_se_families_run_through_grid(grid_panel, se):
    res, disc = _port_grid(f"fwl:c@{se}", grid_panel)
    res_ref, disc_ref = _jax_grid(f"fwl:c@{se}", grid_panel)
    _results_close(res, res_ref, f"fwl@{se}")
    _disclosures_equal(disc, disc_ref)
    assert disc["se_family"] == se
    assert np.isfinite(res["reference"].nw_se[1, :2]).all()


@pytest.mark.parametrize("est", ["iv:b~z", "pooled:cluster_twoway", "pooled:iid",
                                 "fwl:c+z@iid"])
def test_grid_kinds_match_the_reference(grid_panel, est):
    res, disc = _port_grid(est, grid_panel)
    res_ref, disc_ref = _jax_grid(est, grid_panel)
    _results_close(res, res_ref, est)
    _disclosures_equal(disc, disc_ref)


@pytest.mark.parametrize("est", ["fwl:c", "iv:b~z", "pooled:cluster_month"])
def test_factorized_and_per_spec_plans_agree(grid_panel, est):
    """The unique-pair factorized contraction (windows applied to the stats)
    and the per-spec contraction give the same cells; the ledger counts the
    pairs on one and the specs on the other."""
    before = contraction_counts()
    on, _ = _port_grid(est, grid_panel, factorize="on")
    mid = contraction_counts()
    off, _ = _port_grid(est, grid_panel, factorize="off")
    after = contraction_counts()
    _results_close(on, off, f"{est} factorized vs per spec")
    assert mid.get("pairs_contracted", 0) - before.get("pairs_contracted", 0) == 2
    assert after.get("specs_contracted", 0) - mid.get("specs_contracted", 0) == 3
    assert after["specs_solved"] - before["specs_solved"] == 6


@pytest.mark.parametrize("est", ["fwl:c", "iv:b~z", "absorb:ind", "pooled:cluster_twoway"])
def test_coreset_row_weights_compose(grid_panel, est):
    """The coreset route's (T, N) row weights flow into the Gram, FE-cell
    and pooled-meat contractions, as in the reference."""
    y = grid_panel[0]
    rng = np.random.default_rng(73)
    rw = np.where(rng.random(y.shape) < 0.6, 0.5 + 3.0 * rng.random(y.shape), 0.0)
    fe = {"ind": rng.integers(0, 3, size=y.shape)}
    res, disc = _port_grid(est, grid_panel, row_weights=_t(rw), fe_codes=fe)
    res_ref, disc_ref = _jax_grid(est, grid_panel, row_weights=rw, fe_codes=fe)
    _results_close(res, res_ref, f"{est} coreset weights")
    _disclosures_equal(disc, disc_ref)


# --------------------------------------------------- streaming bootstrap
def test_streaming_bootstrap_draw0_chunks_and_merge(grid_panel):
    y, x, masks, grid, _, _ = grid_panel
    base = run_spec_grid_weights(_t(y), _t(x), {k: _t(m) for k, m in masks.items()}, grid,
                                 ("reference",))["reference"]
    args = (base.slopes[:2][:, :, :2], base.r2[:2], base.n_obs[:2], base.month_valid[:2])

    sb = StreamingBootstrap(*args, seed=3, chunk=16, device=CPU)
    assert np.nanmax(np.abs(sb.point - base.coef[:2, :2])) < 1e-12
    sb.extend(64)
    ref = jest.StreamingBootstrap(*args, seed=3, chunk=16)
    ref.extend(64)
    for name in ("mean", "m2", "std", "point", "point_tstat"):
        _close(getattr(sb, name), getattr(ref, name), f"streaming {name}")
    np.testing.assert_array_equal(sb.count, ref.count)

    one = StreamingBootstrap(*args, seed=3, chunk=500, device=CPU)
    one.extend(64)
    assert np.allclose(sb.mean, one.mean, equal_nan=True)
    assert np.allclose(sb.std, one.std, equal_nan=True)
    h1 = StreamingBootstrap(*args, seed=3, chunk=500, device=CPU)
    h1.extend(32)
    h2 = StreamingBootstrap(*args, seed=3, chunk=500, device=CPU)
    h2.draws_done = 32
    h2.extend(64)
    h1.merge(h2)
    assert np.allclose(h1.mean, one.mean, equal_nan=True)
    assert np.allclose(h1.m2, one.m2, equal_nan=True)
    assert one.summary()["draws_done"] == 64
    assert set(one.summary()) == set(ref.summary())


# ------------------------------------------- CellSpace estimator dimension
def _mixed_space(cls=CellSpace):
    est = jest if cls is JaxCellSpace else sys.modules[__name__]
    return cls(
        regressor_sets=(("m1", ("a",)), ("m2", ("a", "b"))),
        universes=("all", "big"),
        windows=(("full", None), ("early", (0, 15))),
        estimators=(est.EST_OLS, est.Estimator(kind="fwl", controls=("c",)),
                    est.Estimator(kind="absorb", absorb=("ind",)),
                    est.Estimator(kind="pooled", se="cluster_month")),
    )


def test_cellspace_estimator_dim_decode_and_union():
    space = _mixed_space()
    assert space.union_predictors == _mixed_space(JaxCellSpace).union_predictors == ("a", "b",
                                                                                      "c")
    for i in range(len(space)):
        assert space.estimators[space.estimator_index(i)] is space.cell(i).estimator
    with pytest.raises(TypeError, match="parse_estimator"):
        CellSpace(regressor_sets=(("m1", ("a",)),), universes=("all",),
                  windows=(("full", None),), estimators=("fwl:c",))


def test_mixed_sweep_ols_cells_match_pure_ols_sweep():
    rng = np.random.default_rng(5)
    t, n = 30, 60
    y = rng.normal(size=(t, n))
    x = rng.normal(size=(t, n, 3))
    masks = {"all": np.ones((t, n), bool), "big": rng.random((t, n)) > 0.3}
    codes = rng.integers(0, 3, size=(t, n))
    frame, _ = run_cellspace(_t(y), _t(x), {k: _t(m) for k, m in masks.items()},
                             _mixed_space(), fe_codes={"ind": codes})
    want, _ = jax_run_cellspace(y, x, masks, _mixed_space(JaxCellSpace),
                                fe_codes={"ind": codes})
    _frames_close(frame, want, "mixed sweep")
    assert {"estimator", "se_family", "suspect_months", "absorb_iters",
            "absorb_converged"} <= set(frame.columns)
    ab = frame[frame["estimator"].str.startswith("absorb")]
    assert len(ab) and ab["absorb_converged"].all()

    space_ols = CellSpace(regressor_sets=_mixed_space().regressor_sets, universes=("all", "big"),
                          windows=_mixed_space().windows)
    frame_ols, _ = run_cellspace(_t(y), _t(x[:, :, :2]), {k: _t(m) for k, m in masks.items()},
                                 space_ols)
    key = ["model", "universe", "window", "predictor"]
    got = (frame[frame["estimator"] == "ols"].sort_values(key)
           [["coef", "tstat", "mean_r2"]].to_numpy())
    pure = frame_ols.sort_values(key)[["coef", "tstat", "mean_r2"]].to_numpy()
    assert np.allclose(got, pure, equal_nan=True)


def test_engine_loud_validations():
    """The engine's up-front refusals, with the reference's exception
    types: absorb without FE codes (KeyError), pooled with bootstrap draws,
    an OLS cell off the NW tail, and draws under another SE family
    (ValueError)."""
    rng = np.random.default_rng(9)
    t, n = 12, 20
    y = rng.normal(size=(t, n))
    x = rng.normal(size=(t, n, 1))
    masks = {"all": np.ones((t, n), bool)}
    cases = [(KeyError, "ind", dict(estimators=("absorb:ind",))),
             (ValueError, "bootstrap", dict(bootstrap=3, estimators=("pooled:iid",))),
             (ValueError, "NW grid tail", dict(estimators=("ols@iid",))),
             (ValueError, "se != 'nw'", dict(bootstrap=3, estimators=("fwl:a@iid",)))]
    for exc, match, kw in cases:
        for pkg, cls, run, tensors in ((sys.modules[__name__], CellSpace, run_cellspace, True),
                                       (jest, JaxCellSpace, jax_run_cellspace, False)):
            space = cls(regressor_sets=(("m1", ("a",)),), universes=("all",),
                        windows=(("full", None),), bootstrap=kw.get("bootstrap", 1),
                        estimators=tuple(pkg.parse_estimator(e) for e in kw["estimators"]))
            args = ((_t(y), _t(x), {"all": _t(masks["all"])}) if tensors else (y, x, masks))
            with pytest.raises(exc, match=match):
                run(*args, space)


# ---------------------------------------------------- bank-served queries
@pytest.fixture(scope="module")
def banks(grid_panel):
    y, x, masks, _, _, names = grid_panel
    kw = dict(regressor_sets=(("m2", names),), universes=("all",), windows=(("full", None),))
    port = grambank.build_bank(y, x, masks, CellSpace(**kw), device=CPU)
    ref = jax_grambank.build_bank(y, x, masks, JaxCellSpace(**kw))
    return port, ref


def _query_close(got, want, what):
    res, disc = got
    res_ref, disc_ref = want
    for name in ("slopes", "r2", "n_obs", "coef", "tstat", "nw_se", "mean_r2", "mean_n"):
        _close(getattr(res, name), getattr(res_ref, name), f"{what} {name}")
    for name in ("month_valid", "n_months", "suspect_months"):
        np.testing.assert_array_equal(np.asarray(getattr(res, name)),
                                      np.asarray(getattr(res_ref, name)), err_msg=name)
    _disclosures_equal(disc, disc_ref)


def test_bank_estimator_query_zero_contractions(banks, grid_panel):
    port, ref = banks
    y, x, masks, _, _, names = grid_panel
    before = contraction_counts()
    got = grambank.estimator_query(port, "fwl:c", device=CPU)
    assert contraction_counts() == before, "estimator_query touched the (T, N, P) panel"
    _query_close(got, jax_grambank.estimator_query(ref, "fwl:c"), "bank fwl")
    assert got[1]["kind"] == "fwl"
    grid = SpecGrid(specs=(Spec("m2", names, "all"),), union=names)
    res_g, _ = run_estimator_grid_weights(parse_estimator("fwl:c"), _t(y), _t(x),
                                          {k: _t(m) for k, m in masks.items()}, grid,
                                          ("reference",))
    assert np.nanmax(np.abs(got[0].coef[0] - res_g["reference"].coef[0])) < 1e-12


@pytest.mark.parametrize("est", ["iv:b~z", "pooled:cluster_month", "pooled:iid", "ols@iid",
                                 "ols@cluster", "fwl:c@cluster"])
def test_bank_serves_each_kind_as_the_reference(banks, est):
    port, ref = banks
    before = contraction_counts()
    got = grambank.estimator_query(port, est, window=(5, 25), device=CPU)
    assert contraction_counts() == before
    _query_close(got, jax_grambank.estimator_query(ref, est, window=(5, 25)), f"bank {est}")
    assert np.isfinite(got[0].coef[0][got[1]["col_sel"][0]]).all()


def test_bank_iv_and_pooled_serve_absorb_rejects(banks):
    port, ref = banks
    for bank, query in ((port, lambda *a: grambank.estimator_query(*a, device=CPU)),
                        (ref, jax_grambank.estimator_query)):
        with pytest.raises(ValueError, match="absorb"):
            query(bank, "absorb:ind")
        for se in ("cluster_firm", "white", "cluster_twoway"):
            with pytest.raises(ValueError, match=se):
                query(bank, f"pooled:{se}")
        with pytest.raises(KeyError):
            query(bank, "fwl:not_a_column")


def test_bank_scenario_sweep_estimator_zero_contractions(banks):
    port, ref = banks
    kw = dict(windows={"full": None, "late": (15, 30)}, estimator="fwl:c", bootstrap=3)
    before = contraction_counts()
    df = grambank.scenario_query(port, device=CPU, **kw)
    assert contraction_counts() == before
    _frames_close(df, jax_grambank.scenario_query(ref, **kw), "bank scenario fwl")
    assert set(df["estimator"]) == {"fwl[c]"} and df["draw"].max() == 2
    assert not df["predictor"].isin(["c"]).any()
    for bank, query in ((port, lambda *a, **k: grambank.scenario_query(*a, device=CPU, **k)),
                        (ref, jax_grambank.scenario_query)):
        with pytest.raises(ValueError, match="bootstrap"):
            query(bank, estimator="pooled:iid", bootstrap=2)


# ------------------------------------------------------- rolling windows
@pytest.mark.parametrize("case", ["fused", "figure", "empty"])
def test_rolling_fm_windows_matches_both_rolls(case):
    """``boot.rolling_fm_windows`` against the reference's and against the
    port's ``rolling_over_valid_rows`` (the cases of
    ``tests/test_boot_device.py``: 90 × 3 at w 24 / min 12, the figure's
    48 × 5 at 12 / 6, and an empty series)."""
    rng = np.random.default_rng({"fused": 3, "figure": 6, "empty": 0}[case])
    t, p, window, mp = {"fused": (90, 3, 24, 12), "figure": (48, 5, 12, 6),
                        "empty": (5, 2, 3, 1)}[case]
    slopes = rng.standard_normal((t, p))
    valid = rng.random(t) > 0.2 if case != "empty" else np.zeros(t, bool)
    got = boot.rolling_fm_windows(slopes, valid, window, mp, device=CPU)
    want = jax_rolling_fm_windows(slopes, valid, window, mp)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    if case == "empty":
        assert np.isnan(got).all()
        return
    fused = _np(rolling_over_valid_rows(_t(slopes), _t(valid), window, mp))
    np.testing.assert_allclose(got, fused, atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jax_rolling_rows(jnp.asarray(slopes), jnp.asarray(valid), window, mp)),
        atol=1e-12, rtol=0)
    assert np.isnan(got[~valid]).all()


# ------------------------------------------------ the GPU default, here
def test_new_entry_points_default_to_the_gpu(banks, grid_panel, monkeypatch):
    """``device=None`` means the GPU for every new entry point, so each
    raises on a machine without one."""
    port, _ = banks
    y, x, masks, grid, _, _ = grid_panel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: grambank.estimator_query(port, "fwl:c"),
        lambda: grambank.scenario_query(port, estimator="fwl:c"),
        lambda: scenarios.run_scenarios_banked(port, estimator="iv:b~z"),
        lambda: StreamingBootstrap(np.zeros((1, 4, 2)), np.zeros((1, 4)), np.ones((1, 4)),
                                   np.ones((1, 4), bool)),
        lambda: boot.rolling_fm_windows(np.zeros((4, 2)), np.ones(4, bool), 2, 1),
        lambda: run_estimator_grid_weights(parse_estimator("fwl:c"), y, x, masks, grid,
                                           ("reference",)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ----------------------------------------- the sweep, the pipeline, the CLI
class _MiniPanel:
    def __init__(self, y, x, mask, names):
        self.y, self.x, self.mask, self.names = y, x, mask, names
        self.months = np.arange(y.shape[0])

    def var(self, name):
        assert name == "retx"
        return self.y

    def select(self, cols):
        return self.x[:, :, [self.names.index(c) for c in cols]]


def test_run_scenarios_estimators_match_the_reference():
    """``run_scenarios(estimators=..., fe_codes=...)``: one sweep over five
    estimator cells (FWL, IV, one- and two-way absorb, pooled two-way) and
    the banked twin ``run_scenarios_banked(estimator=...)``, against the
    reference's frames."""
    from fm_returnprediction_tpu.models.lewellen import ModelSpec as JaxModelSpec
    from fm_returnprediction_tpu.specgrid import scenarios as jax_scenarios
    from fm_returnprediction_tpu_torch.models.lewellen import ModelSpec

    rng = np.random.default_rng(21)
    t, n, names = 36, 80, ["c0", "c1", "c2", "c3"]
    x = rng.standard_normal((t, n, 4))
    x[rng.random(x.shape) < 0.05] = np.nan
    y = np.nansum(x * np.array([0.1, -0.2, 0.05, 0.0]), axis=-1) + rng.standard_normal((t, n))
    masks = {"All": np.ones((t, n), bool), "Big": (rng.random(n) > 0.3)[None, :]
             & np.ones((t, n), bool)}
    variables = {"V0": "c0", "V1": "c1", "V2": "c2", "V3": "c3"}
    fe = {"ind": rng.integers(0, 5, (t, n)), "size": rng.integers(0, 3, (t, n))}
    ests = ("fwl:c0", "iv:c1~c3", "absorb:ind", "absorb:ind+size", "pooled:cluster_twoway")
    sets = [("Model A", ["V0", "V1"]), ("Model B", ["V0", "V1", "V2"])]
    kw = dict(subperiods=2, min_months=8, estimators=ests, fe_codes=fe)
    got = scenarios.run_scenarios(
        _MiniPanel(_t(y), _t(x), _t(masks["All"]), names),
        {k: _t(m) for k, m in masks.items()}, variables,
        models=[ModelSpec(*s) for s in sets], **kw)
    want = jax_scenarios.run_scenarios(_MiniPanel(y, x, masks["All"], names), masks, variables,
                                       models=[JaxModelSpec(*s) for s in sets], **kw)
    _frames_close(got, want, "run_scenarios estimators")
    assert set(got["estimator"]) == {"fwl[c0]", "iv[c1~c3]", "absorb[ind]", "absorb[ind+size]",
                                     "pooled"}

    bank = scenarios.bank_for_scenarios(_MiniPanel(y, x, masks["All"], names), masks, variables,
                                        models=[ModelSpec(*s) for s in sets], min_months=8,
                                        device=CPU)
    jbank = jax_scenarios.bank_for_scenarios(_MiniPanel(y, x, masks["All"], names), masks,
                                             variables, models=[JaxModelSpec(*s) for s in sets],
                                             min_months=8)
    windows = scenarios.subperiod_windows(t, 2)
    _frames_close(scenarios.run_scenarios_banked(bank, windows=windows, estimator="fwl:c0",
                                                 variables_dict=variables, device=CPU),
                  jax_scenarios.run_scenarios_banked(jbank, windows=windows, estimator="fwl:c0",
                                                     variables_dict=variables),
                  "run_scenarios_banked fwl")


@pytest.fixture(scope="module")
def pipeline_inputs():
    from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
    from fm_returnprediction_tpu.panel.subsets import compute_subset_masks
    from fm_returnprediction_tpu.pipeline import build_panel, build_panel_prepared

    capture = {}
    build_panel(generate_synthetic_wrds(SyntheticConfig(n_firms=60, n_months=96)),
                dtype=np.float64, capture=capture)
    base, daily = capture["dense_base"], capture["compact_daily"]
    panel, factors = build_panel_prepared(base, daily, dtype=np.float64)
    return dict(base=base, daily=daily, panel=panel, factors=factors,
                masks=compute_subset_masks(panel))


def test_run_pipeline_specgrid_estimator_matches(pipeline_inputs):
    """``run_pipeline(specgrid_estimator="fwl:log_size")`` — the sweep and
    the backtest stage both under FWL — against the reference's
    ``run_scenarios``/``run_backtest_scenarios`` on its own panel."""
    from fm_returnprediction_tpu.backtest import run_backtest_scenarios as jax_backtest
    from fm_returnprediction_tpu.specgrid.scenarios import run_scenarios as jax_run_scenarios
    from fm_returnprediction_tpu_torch.convert import prepared_from_numpy
    from fm_returnprediction_tpu_torch.pipeline import run_pipeline

    ins = pipeline_inputs
    base, daily = prepared_from_numpy(ins["base"], ins["daily"])
    res = run_pipeline(dense_base=base, compact_daily=daily, device=CPU, dtype=torch.float64, make_figure=False,
                       make_deciles=False, make_serving=False, make_specgrid=True,
                       make_backtest=True, specgrid_estimator="fwl:log_size",
                       backtest_schemes="expanding,rolling24", backtest_quantiles=5)
    est = jest.parse_estimator("fwl:log_size")
    want = jax_run_scenarios(ins["panel"], ins["masks"], ins["factors"], estimators=(est,))
    _frames_close(res.specgrid_scenarios, want, "pipeline specgrid fwl")
    assert set(res.specgrid_scenarios["estimator"]) == {"fwl[log_size]"}
    assert "Log Size (-1)" not in set(res.specgrid_scenarios["predictor"])
    bt = jax_backtest(ins["panel"], ins["masks"], ins["factors"],
                      schemes="expanding,rolling24", n_quantiles=5, estimator="fwl:log_size")
    _frames_close(res.backtest_table, bt, "pipeline backtest fwl")
    assert set(res.backtest_table["estimator"]) == {"fwl[log_size]"}


def _cli(module, out, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), DTYPE="float64", JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1")
    env.pop("FMRP_SPECGRID_ESTIMATOR", None)
    cmd = [sys.executable, "-m", module, "--synthetic", "--firms", "60", "--months", "72",
           "--specgrid", *extra]
    if out is not None:
        cmd += ["--output-dir", str(out)]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=400)


def test_cli_specgrid_estimator_matches_the_jax_cli(tmp_path):
    """``--specgrid --specgrid-estimator iv:log_bm~log_issues_36`` through
    both command lines (float64): the same ``specgrid_scenarios.csv``; and
    ``--specgrid-estimator absorb:ind`` exits non-zero in both (the
    pipeline has no FE codes), with the engine's KeyError. Each command
    line builds its own panel from the synthetic frames (the two enriched
    panels agree at 1e-10, ``tests/test_torch_ingest.py``), and the cells
    here disclose suspect months (the instrument is weak at 60 firms, and
    it is a structural column of Models 2 and 3) or solve 14 predictors
    on 60 firms, which amplify that input gap to ~5e-10: the frames are held at 1e-8, the pipeline tests' pin for
    frames from separately built panels (``tests/test_torch_pipeline.py``);
    labels, counts and flags exactly."""
    spec = "iv:log_bm~log_issues_36"
    jax_done = _cli("fm_returnprediction_tpu.pipeline", tmp_path / "jax",
                    "--specgrid-estimator", spec, "--backend", "cpu")
    port_done = _cli("fm_returnprediction_tpu_torch.pipeline", tmp_path / "port",
                     "--specgrid-estimator", spec, "--device", "cpu")
    assert jax_done.returncode == 0, jax_done.stderr[-3000:]
    assert port_done.returncode == 0, port_done.stderr[-3000:]
    got = pd.read_csv(tmp_path / "port" / "specgrid_scenarios.csv")
    want = pd.read_csv(tmp_path / "jax" / "specgrid_scenarios.csv")
    _frames_close(got, want, "CLI iv", tol=1e-8)
    assert set(got["estimator"]) == {"iv[log_bm~log_issues_36]"}
    for module, flag in (("fm_returnprediction_tpu_torch.pipeline", ["--device", "cpu"]),
                         ("fm_returnprediction_tpu.pipeline", ["--backend", "cpu"])):
        done = _cli(module, None, "--specgrid-estimator", "absorb:ind", *flag)
        assert done.returncode != 0 and "KeyError" in done.stderr, done.stderr[-2000:]
