"""The rolling-origin backtest and the FWL transform, the port vs the JAX
package on the CPU.

Inputs are the JAX package's own fixtures (``tests/test_backtest.py``: a
30-month × 140-firm × 4-column float64 panel banked over 2 sets × 2
universes, and the seeded oracle panels), fed to both packages as the same
numpy arrays. Compared:

- the scan and refit coefficient paths against the JAX package's for
  ``expanding``/``rolling12`` × OLS/``fwl:c0`` (paths, counts, per-month
  leaves at 1e-12 of ``max(|value|, 1)``, NaN patterns, month gates and
  suspect flags exact), and the port's own scan ≡ refit at the reference's
  pin 1e-13;
- forecasts (strictly past), OOS R², Pearson/rank IC on a tied panel, NW
  series inference, the block bootstrap and EW/VW quantile sorts against
  the JAX package and the numpy oracles at the reference's ``ORACLE_TOL``
  1e-10, counts and buckets exact;
- ``fwl_transform`` and ``masked_psd_solve`` at 1e-12, with a
  rank-deficient control block;
- ``run_backtest_scenarios`` frames at rtol 1e-9, labels and counts exact,
  with and without the VW weight column;
- the loud rejections, the knob precedence, the sinks, and
  ``backtest_rules`` on a planted out-of-band frame.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from fm_returnprediction_tpu import backtest as jax_bt
from fm_returnprediction_tpu.backtest import sinks as jax_bt_sinks
from fm_returnprediction_tpu.guard import contracts as jax_contracts
from fm_returnprediction_tpu.models.lewellen import ModelSpec as JaxModelSpec
from fm_returnprediction_tpu.specgrid import grambank as jax_grambank
from fm_returnprediction_tpu.specgrid.cellspace import CellSpace as JaxCellSpace
from fm_returnprediction_tpu.specgrid.estimators.core import (
    masked_psd_solve as jax_masked_psd_solve,
)
from fm_returnprediction_tpu.specgrid.estimators.fwl import fwl_transform as jax_fwl_transform
from fm_returnprediction_tpu.specgrid.grams import SpecGramStats as JaxSpecGramStats
from fm_returnprediction_tpu_torch import backtest as bt
from fm_returnprediction_tpu_torch.backtest.space import BacktestSpace
from fm_returnprediction_tpu_torch.guard import contracts
from fm_returnprediction_tpu_torch.models.lewellen import ModelSpec
from fm_returnprediction_tpu_torch.ops.newey_west import nw_mean_se_np
from fm_returnprediction_tpu_torch.specgrid import grambank
from fm_returnprediction_tpu_torch.specgrid.cellspace import CellSpace
from fm_returnprediction_tpu_torch.specgrid.estimators import fwl_transform, masked_psd_solve
from fm_returnprediction_tpu_torch.specgrid.grams import SpecGramStats

pytestmark = pytest.mark.torch_port

CPU = "cpu"
TOL = 1e-13          # scan vs refit, the reference's float64 pin
ORACLE_TOL = 1e-10   # device function vs the float64 host oracle
PARITY = 1e-12       # port vs JAX package, of max(|value|, 1)


def _panel(seed=0, t=30, n=140, p=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < 0.06] = np.nan
    beta = rng.standard_normal(p) * 0.1
    y = np.nansum(x * beta, axis=-1) + 0.3 * rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.1] = np.nan
    masks = {
        "All": np.ones((t, n), bool),
        "Big": (rng.random(n) > 0.35)[None, :] & np.ones((t, n), bool),
    }
    return y, x, masks


def _space_kw(p=4):
    names = tuple(f"c{i}" for i in range(p))
    return dict(regressor_sets=(("m2", names[:2]), ("mfull", names)), universes=("All", "Big"),
                windows=(("full", None),), nw_lags=4, min_months=8)


@pytest.fixture(scope="module")
def banks():
    y, x, masks = _panel()
    port = grambank.build_bank(y, x, masks, CellSpace(**_space_kw()),
                               fingerprint="test-backtest", device=CPU)
    ref = jax_grambank.build_bank(y, x, masks, JaxCellSpace(**_space_kw()),
                                  fingerprint="test-backtest")
    return port, ref, (y, x, masks)


def _close_scaled(got, want, tol, what):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= tol * np.maximum(np.abs(want[fin]), 1.0)), what


# -- coefficient paths -------------------------------------------------------

@pytest.mark.parametrize("route", ["scan", "refit"])
@pytest.mark.parametrize("scheme", ["expanding", "rolling12"])
@pytest.mark.parametrize("estimator", [None, "fwl:c0"])
def test_paths_match_jax(banks, route, scheme, estimator):
    port, ref, _ = banks
    got = bt.backtest_paths(port, scheme, estimator=estimator, route=route, min_months=5,
                            device=CPU)
    want = jax_bt.backtest_paths(ref, scheme, estimator=estimator, route=route, min_months=5)
    assert (got.route, got.scheme, got.window, got.estimator_label) == \
        (want.route, want.scheme, want.window, want.estimator_label)
    for f in ("path", "count", "beta"):
        _close_scaled(getattr(got, f), getattr(want, f), PARITY, f)
    for f in ("month_valid", "suspect", "col_sel"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert np.isfinite(got.path).any()


@pytest.mark.parametrize("scheme", ["expanding", "rolling12"])
@pytest.mark.parametrize("estimator", [None, "fwl:c0"])
def test_scan_matches_refit_oracle(banks, scheme, estimator):
    """The prefix-sum program and the per-origin full-refit loop are the
    same numbers up to summation order (exact by Gram additivity)."""
    port, _, _ = banks
    scan = bt.backtest_paths(port, scheme, estimator=estimator, route="scan", min_months=5,
                             device=CPU)
    refit = bt.backtest_paths(port, scheme, estimator=estimator, route="refit", min_months=5,
                              device=CPU)
    assert scan.route == "scan" and refit.route == "refit"
    np.testing.assert_array_equal(np.isnan(scan.path), np.isnan(refit.path))
    np.testing.assert_allclose(scan.path, refit.path, atol=TOL, equal_nan=True)
    np.testing.assert_allclose(scan.count, refit.count, atol=TOL)
    np.testing.assert_array_equal(scan.month_valid, refit.month_valid)
    np.testing.assert_allclose(scan.beta, refit.beta, atol=TOL)
    np.testing.assert_array_equal(scan.col_sel, refit.col_sel)


def test_rolling_path_is_prefix_difference(banks):
    port, _, _ = banks
    w = 12
    paths = bt.backtest_paths(port, f"rolling{w}", route="scan", min_months=5, device=CPU)
    k, origin = 0, port.n_months - 1
    sel = paths.month_valid[k, origin - w + 1:origin + 1]
    want = paths.beta[k, origin - w + 1:origin + 1][sel].mean(axis=0)
    np.testing.assert_allclose(paths.path[k, origin], want, atol=ORACLE_TOL)
    assert paths.count[k, origin] == sel.sum()


def test_fwl_paths_drop_the_control_and_zero_the_intercept(banks):
    port, _, _ = banks
    ols = bt.backtest_paths(port, "expanding", route="scan", min_months=5, device=CPU)
    fwl = bt.backtest_paths(port, "expanding", estimator="fwl:c0", route="scan", min_months=5,
                            device=CPU)
    assert (fwl.estimator_label, ols.estimator_label) == ("fwl[c0]", "ols")
    assert fwl.col_sel.sum() < ols.col_sel.sum()
    finite = np.isfinite(fwl.path[..., 0])
    assert finite.any()
    np.testing.assert_allclose(fwl.path[..., 0][finite], 0.0, atol=TOL)


# -- forecasts and evaluation ------------------------------------------------

def test_predict_er_is_strictly_past_and_matches_jax(banks):
    port, ref, (y, x, masks) = banks
    paths = bt.backtest_paths(port, "expanding", route="scan", min_months=5, device=CPU)
    pair = 1
    er, er_valid = bt.predict_er(paths, x, masks["Big"], pair, device=CPU)
    want_er, want_valid = jax_bt.predict_er(
        jax_bt.backtest_paths(ref, "expanding", route="scan", min_months=5), x, masks["Big"],
        pair)
    np.testing.assert_array_equal(er_valid, want_valid)
    _close_scaled(er, want_er, PARITY, "er")
    assert not er_valid[0].any()
    sel = paths.col_sel[pair]
    t_probe = port.n_months - 1
    rows = np.flatnonzero(er_valid[t_probe])
    assert rows.size
    coef = paths.path[pair, t_probe - 1]
    np.testing.assert_allclose(er[t_probe, rows], coef[0] + x[t_probe][rows][:, sel] @ coef[1:][sel],
                               atol=ORACLE_TOL)
    assert not (er_valid & ~np.isfinite(x[..., sel]).all(axis=-1)).any()
    assert not er_valid[:, ~masks["Big"][0]].any()


def test_oos_r2_matches_jax_and_the_oracle(banks):
    port, _, (y, x, masks) = banks
    paths = bt.backtest_paths(port, "expanding", route="scan", min_months=5, device=CPU)
    er, er_valid = bt.predict_er(paths, x, masks["All"], 1, device=CPU)
    got = float(bt.oos_r2(torch.from_numpy(er), torch.from_numpy(er_valid), torch.from_numpy(y)))
    want = bt.oos_r2_np(er, er_valid, y)
    assert np.isfinite(want) and want == jax_bt.oos_r2_np(er, er_valid, y)
    np.testing.assert_allclose(got, want, atol=ORACLE_TOL)
    np.testing.assert_allclose(
        got, float(jax_bt.oos_r2(jnp.asarray(er), jnp.asarray(er_valid), jnp.asarray(y))),
        atol=ORACLE_TOL)


def _tied_ic_panel():
    rng = np.random.default_rng(7)
    t, n = 25, 60
    er = np.round(rng.standard_normal((t, n)), 1)  # many exact ties
    realized = 0.4 * er + rng.standard_normal((t, n))
    er_valid = rng.random((t, n)) > 0.15
    realized[rng.random((t, n)) < 0.1] = np.nan
    return er, er_valid, realized


def test_ic_series_matches_jax_and_the_oracle_with_ties():
    er, er_valid, realized = _tied_ic_panel()
    ic, rank_ic, good = bt.ic_series(torch.from_numpy(er), torch.from_numpy(er_valid),
                                     torch.from_numpy(realized), min_obs=10)
    ic_np, rank_np = bt.ic_series_np(er, er_valid, realized, min_obs=10)
    want = jax_bt.ic_series(jnp.asarray(er), jnp.asarray(er_valid), jnp.asarray(realized),
                            min_obs=10)
    for got, oracle, ref in ((ic, ic_np, want[0]), (rank_ic, rank_np, want[1])):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(oracle))
        np.testing.assert_allclose(got.numpy(), oracle, atol=ORACLE_TOL, equal_nan=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ORACLE_TOL, equal_nan=True)
    np.testing.assert_array_equal(good.numpy(), np.asarray(want[2]))
    assert good.numpy().sum() > er.shape[0] // 2
    ranks = bt.evaluate._ordinal_ranks(torch.from_numpy(er), torch.from_numpy(er_valid))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jax_bt.evaluate._ordinal_ranks(
        jnp.asarray(er), jnp.asarray(er_valid))))


def test_series_inference_matches_jax_and_nw_oracle():
    rng = np.random.default_rng(3)
    series = rng.standard_normal(40) + 0.5
    series[[4, 17]] = np.nan
    mean, se, tstat, n = bt.series_inference(series, nw_lags=4, device=CPU)
    want = jax_bt.series_inference(series, nw_lags=4)
    ok = np.isfinite(series)
    assert n == want[3] == ok.sum()
    np.testing.assert_allclose((mean, se, tstat), want[:3], atol=ORACLE_TOL)
    np.testing.assert_allclose(mean, series[ok].mean(), atol=ORACLE_TOL)
    np.testing.assert_allclose(se, nw_mean_se_np(series[ok], 4), atol=ORACLE_TOL)
    np.testing.assert_allclose(tstat, mean / se, atol=ORACLE_TOL)


def _sorts_panel():
    rng = np.random.default_rng(11)
    t, n = 24, 90
    er = np.round(rng.standard_normal((t, n)), 1)
    realized = 0.3 * er + rng.standard_normal((t, n))
    er_valid = rng.random((t, n)) > 0.1
    realized[rng.random((t, n)) < 0.08] = np.nan
    weights = np.abs(rng.lognormal(size=(t, n))) + 0.1
    weights[rng.random((t, n)) < 0.05] = np.nan
    return er, er_valid, realized, weights


def _sorts_np(er, er_valid, realized, n_q, min_obs, weights=None):
    """Host oracle: per-month np.quantile interior breakpoints, bucket =
    breakpoints strictly below, normalized holdings, one-way turnover."""
    t, n = er.shape
    ok = np.asarray(er_valid, bool) & np.isfinite(realized)
    if weights is not None:
        ok = ok & np.isfinite(weights) & (weights > 0)
    month_valid = ok.sum(axis=1) >= min_obs
    qret = np.full((t, n_q), np.nan)
    counts = np.zeros((t, n_q), int)
    wnorm = np.zeros((t, n_q, n))
    qs = np.arange(1, n_q) / n_q
    for m in range(t):
        rows = np.flatnonzero(ok[m])
        if not rows.size:
            continue
        vals = er[m, rows]
        bucket = (vals[:, None] > np.quantile(vals, qs)[None, :]).sum(axis=1)
        for d in range(n_q):
            sel = rows[bucket == d]
            counts[m, d] = sel.size
            if not sel.size:
                continue
            w = np.ones(sel.size) if weights is None else weights[m, sel]
            wnorm[m, d, sel] = w / w.sum()
            if month_valid[m]:
                qret[m, d] = float(wnorm[m, d, sel] @ realized[m, sel])
    turnover = np.full((t, n_q), np.nan)
    for m in range(1, t):
        if month_valid[m] and month_valid[m - 1]:
            for d in range(n_q):
                if counts[m, d] and counts[m - 1, d]:
                    turnover[m, d] = 0.5 * np.abs(wnorm[m, d] - wnorm[m - 1, d]).sum()
    return qret, counts, month_valid, turnover


@pytest.mark.parametrize("value_weighted", [False, True])
def test_quantile_sorts_match_jax_and_the_oracle(value_weighted):
    er, er_valid, realized, weights = _sorts_panel()
    n_q = 5
    got = bt.quantile_sorts(torch.from_numpy(er), torch.from_numpy(er_valid),
                            torch.from_numpy(realized),
                            weights=torch.from_numpy(weights) if value_weighted else None,
                            n_quantiles=n_q, min_obs=20, value_weighted=value_weighted)
    want = jax_bt.quantile_sorts(jnp.asarray(er), jnp.asarray(er_valid), jnp.asarray(realized),
                                 weights=jnp.asarray(weights) if value_weighted else None,
                                 n_quantiles=n_q, min_obs=20, value_weighted=value_weighted)
    qret, counts, month_valid, turnover = _sorts_np(
        er, er_valid, realized, n_q, 20, weights=weights if value_weighted else None)
    assert any(np.unique(er[m, er_valid[m]]).size < er_valid[m].sum() for m in range(er.shape[0]))
    np.testing.assert_array_equal(got.month_valid.numpy(), month_valid)
    np.testing.assert_array_equal(got.counts.numpy(), counts)
    np.testing.assert_allclose(got.quantile_returns.numpy(), qret, atol=ORACLE_TOL, equal_nan=True)
    np.testing.assert_allclose(got.turnover.numpy(), turnover, atol=ORACLE_TOL, equal_nan=True)
    for f in PortfolioFields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=ORACLE_TOL, equal_nan=True, err_msg=f)
    np.testing.assert_allclose(float(got.spread_tstat), float(got.spread) / float(got.spread_nw_se),
                               atol=ORACLE_TOL)


PortfolioFields = bt.PortfolioResult._fields


def test_equal_forecasts_share_a_bucket():
    t, n, n_q = 4, 30, 3
    rng = np.random.default_rng(5)
    levels = np.array([-1.0, 0.0, 1.0])
    er = levels[rng.integers(0, 3, size=(t, n))]
    port = bt.quantile_sorts(torch.from_numpy(er), torch.ones((t, n), dtype=torch.bool),
                             torch.from_numpy(rng.standard_normal((t, n))), n_quantiles=n_q,
                             min_obs=5)
    counts = port.counts.numpy()
    assert (counts.sum(axis=1) == n).all()
    for m in range(t):
        sizes = [(er[m] == lev).sum() for lev in levels]
        assert set(np.cumsum(counts[m])) <= set(np.concatenate([[0], np.cumsum(sizes)]))


def test_bootstrap_series_matches_jax_and_draw0_is_the_point():
    rng = np.random.default_rng(9)
    series = rng.standard_normal(36) * 0.02 + 0.01
    series[[0, 13]] = np.nan
    point, boot_se, draw_means = bt.bootstrap_series(series, draws=16, seed=3, block=6,
                                                     device=CPU)
    want = jax_bt.bootstrap_series(series, draws=16, seed=3, block=6)
    for got, ref in zip((point, boot_se, draw_means), want):
        np.testing.assert_allclose(got, ref, atol=1e-12)
    np.testing.assert_allclose(point[0], bt.series_inference(series, device=CPU)[0], atol=1e-12)
    assert draw_means.shape == (15, 1) and (boot_se > 0).all()
    two = np.stack([series, 2 * series], axis=1)
    p2, _, dm2 = bt.bootstrap_series(two, draws=16, seed=3, block=6, device=CPU)
    assert dm2.shape == (15, 2)
    np.testing.assert_allclose(p2[1], 2 * p2[0], atol=1e-12)
    p1, se1, dm1 = bt.bootstrap_series(series, draws=1, device=CPU)
    assert dm1.shape == (0, 1) and np.isnan(se1).all()
    with pytest.raises(ValueError, match="draws"):
        bt.bootstrap_series(series, draws=0, device=CPU)


# -- the FWL transform -------------------------------------------------------

def _stats_pair(seed=4, s=3, t=6, q=5, deficient=True):
    """Per-month Gram stats of random designs (intercept + q−1 columns);
    with ``deficient`` the control column c1 of spec 1 month 2 is an exact
    copy of the intercept direction (a constant), so its control block
    loses rank."""
    rng = np.random.default_rng(seed)
    n = 40
    grams = np.zeros((s, t, q, q))
    moments = np.zeros((s, t, q))
    ns = np.zeros((s, t))
    ysum = np.zeros((s, t))
    yy = np.zeros((s, t))
    for i in range(s):
        for m in range(t):
            x = np.concatenate([np.ones((n, 1)), rng.standard_normal((n, q - 1))], axis=1)
            if deficient and (i, m) == (1, 2):
                x[:, 1] = 3.0
            rows = n if (i, m) != (2, 4) else 3   # a thin month the dof gate drops
            x = x[:rows]
            y = x @ rng.standard_normal(q) + rng.standard_normal(rows)
            grams[i, m], moments[i, m] = x.T @ x, x.T @ y
            ns[i, m], ysum[i, m], yy[i, m] = rows, y.sum(), y @ y
    center = np.zeros((t, q - 1))
    return grams, moments, ns, ysum, yy, center


def test_fwl_transform_and_masked_psd_solve_match_jax():
    leaves = _stats_pair()
    q = leaves[0].shape[-1]
    sel_aug = np.ones((3, q), bool)
    sel_aug[0, 4] = False
    ctrl_aug = np.zeros((3, q), bool)
    ctrl_aug[:, :2] = True                        # intercept + c1 as the control block
    eps = float(np.finfo(np.float64).eps)
    got, deficient = fwl_transform(SpecGramStats(*map(torch.from_numpy, leaves)),
                                   torch.from_numpy(sel_aug), torch.from_numpy(ctrl_aug), eps)
    want, want_def = jax_fwl_transform(JaxSpecGramStats(*map(jnp.asarray, leaves)),
                                       jnp.asarray(sel_aug), jnp.asarray(ctrl_aug), eps)
    np.testing.assert_array_equal(deficient.numpy(), np.asarray(want_def))
    assert deficient.numpy()[1, 2] and deficient.numpy().sum() == 1
    assert got.n.numpy()[2, 4] == 0                 # the dof gate
    for f in SpecGramStats._fields:
        _close_scaled(getattr(got, f).numpy(), getattr(want, f), 1e-12, f)

    mask = np.broadcast_to(ctrl_aug[:, None, :], leaves[0].shape[:-1])
    rhs = np.concatenate([leaves[0], leaves[1][..., None]], axis=-1)
    x, dfc = masked_psd_solve(torch.from_numpy(leaves[0]), torch.from_numpy(mask.copy()),
                              torch.from_numpy(rhs), eps)
    x_ref, dfc_ref = jax_masked_psd_solve(jnp.asarray(leaves[0]), jnp.asarray(mask),
                                          jnp.asarray(rhs), eps)
    np.testing.assert_array_equal(dfc.numpy(), np.asarray(dfc_ref))
    _close_scaled(x.numpy(), x_ref, 1e-12, "masked_psd_solve")


def test_masked_psd_solve_takes_a_non_finite_system():
    """A non-finite system decomposes the identity in its place: NaN
    solution, flagged deficient (the reference's eigh returns NaN there;
    torch's would raise)."""
    leaves = _stats_pair(deficient=False)
    gram = leaves[0].copy()
    gram[0, 1, 2, 2] = np.inf
    mask = np.ones(gram.shape[:-1], bool)
    x, dfc = masked_psd_solve(torch.from_numpy(gram), torch.from_numpy(mask),
                              torch.from_numpy(leaves[1][..., None]), 1e-16)
    assert dfc.numpy()[0, 1] and np.isnan(x.numpy()[0, 1]).all()
    assert np.isfinite(x.numpy()[0, 0]).all() and not dfc.numpy()[0, 0]


# -- the sweep ---------------------------------------------------------------

class _MiniPanel:
    def __init__(self, y, x, masks, names, me=None):
        self.y, self.x, self.me, self.names = y, x, me, names
        self.mask = masks["All"]
        self.months = np.arange(y.shape[0])
        self.var_names = ["retx"] + names + (["me"] if me is not None else [])

    def var(self, name):
        return {"retx": self.y, "me": self.me}[name]

    def select(self, cols):
        return self.x[:, :, [self.names.index(c) for c in cols]]


def _assert_frames_match(got, want, rtol=1e-9):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            g, w = got[c].to_numpy(float), want[c].to_numpy(float)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-13, equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=c)


@pytest.mark.parametrize("with_me", [True, False])
def test_run_backtest_scenarios_frames_match_jax(with_me):
    y, x, masks = _panel(seed=21, t=24, n=80, p=3)
    names = ["c0", "c1", "c2"]
    me = np.abs(np.random.default_rng(4).lognormal(size=y.shape)) + 0.1 if with_me else None
    variables = {"V0": "c0", "V1": "c1", "V2": "c2"}
    preds = (("Model A", ["V0", "V1"]), ("Model B", ["V0", "V1", "V2"]))
    kw = dict(schemes="expanding,rolling8", n_quantiles=4, min_obs=15, min_months=5,
              bootstrap=5, seed=2, return_stats=True)
    got, stats = bt.run_backtest_scenarios(
        _MiniPanel(y, x, masks, names, me), masks, variables,
        models=[ModelSpec(a, b) for a, b in preds], device=CPU, **kw)
    want, want_stats = jax_bt.run_backtest_scenarios(
        _MiniPanel(y, x, masks, names, me), masks, variables,
        models=[JaxModelSpec(a, b) for a, b in preds], **kw)
    _assert_frames_match(got, want)
    assert stats["panel_contractions"] == 0
    assert stats["weighting_reduced"] is (not with_me)
    assert set(got["weighting"]) == ({"ew", "vw"} if with_me else {"ew"})
    assert len(got) == 2 * 2 * 2 * (2 if with_me else 1)
    for key in ("cells", "tiles", "route", "sink", "schemes", "weightings", "quantiles",
                "bootstrap", "path_solves", "predict_calls", "rows_seen", "panel_contractions",
                "weighting_reduced"):
        assert stats[key] == want_stats[key], key
    if not with_me:
        with pytest.raises(ValueError, match="weight column"):
            bt.run_backtest_scenarios(_MiniPanel(y, x, masks, names), masks, variables,
                                      models=[ModelSpec(a, b) for a, b in preds],
                                      weightings=("vw",), min_months=5, device=CPU)


def test_run_backtest_fwl_sweep_matches_jax(banks):
    port, ref, (y, x, masks) = banks
    weights = np.abs(np.random.default_rng(2018).lognormal(size=y.shape)) + 0.1
    kw = dict(schemes="expanding,rolling12", estimators=("fwl:c0",), weightings=("ew", "vw"),
              n_quantiles=5, min_obs=20)
    space = bt.backtest_space(port, **kw)
    got, stats = bt.run_backtest(port, x, y, masks, space=space, weights_var=weights,
                                 min_months=5, tile_cells=3, device=CPU)
    want, _ = jax_bt.run_backtest(ref, x, y, masks, space=jax_bt.backtest_space(ref, **kw),
                                  weights_var=weights, min_months=5, tile_cells=3)
    _assert_frames_match(got, want)
    assert stats["panel_contractions"] == 0 and stats["tiles"] == 6
    assert stats["path_solves"] == 2 and stats["predict_calls"] == 2 * space.n_pairs
    assert (got["estimator"] == "fwl[c0]").all()


def test_metrics_sink_matches_jax(banks):
    port, _, (y, x, masks) = banks
    weights = np.abs(np.random.default_rng(2018).lognormal(size=y.shape)) + 0.1
    space = bt.backtest_space(port, schemes="expanding,rolling12", weightings=("ew", "vw"),
                              n_quantiles=5, min_obs=20)
    frame, _ = bt.run_backtest(port, x, y, masks, space=space, weights_var=weights,
                               min_months=5, device=CPU)
    got, want = bt.MetricsSink(), jax_bt_sinks.MetricsSink()
    for sink in (got, want):
        sink.consume(frame.iloc[:5])
        sink.consume(frame.iloc[5:])
    pd.testing.assert_frame_equal(got.finish(), want.finish())
    assert len(got.finish()) == 4 and got.rows_seen == len(frame)
    top, top_ref = bt.resolve_backtest_sink("topk"), jax_bt.resolve_backtest_sink("topk")
    for sink in (top, top_ref):
        sink.consume(frame)
    pd.testing.assert_frame_equal(top.finish().reset_index(drop=True),
                                  top_ref.finish().reset_index(drop=True))


def test_cell_space_matches_jax(banks):
    port, ref, _ = banks
    kw = dict(schemes="expanding,rolling12,rolling3", estimators=("ols", "fwl:c0"),
              weightings=("ew", "vw"), n_quantiles=4)
    got, want = bt.backtest_space(port, **kw), jax_bt.backtest_space(ref, **kw)
    assert len(got) == len(want) == 3 * 2 * 4 * 2 and got.dims == want.dims
    for i in range(len(got)):
        a, b = got.cell(i), want.cell(i)
        assert a._replace(estimator=None) == b._replace(estimator=None)
        assert dataclasses.asdict(a.estimator) == dataclasses.asdict(b.estimator)
        assert (got.pair_index(i), got.path_key(i)) == (want.pair_index(i), want.path_key(i))
    assert [(t.start, t.stop) for t in got.tiles(7)] == [(t.start, t.stop) for t in want.tiles(7)]


# -- loud rejections and knobs ----------------------------------------------

def test_non_composing_estimators_rejected_loudly(banks):
    port, _, _ = banks
    for est in ("pooled", "iv:c0~c1", "absorb:c1"):
        with pytest.raises(ValueError, match="not available here"):
            bt.backtest_paths(port, "expanding", estimator=est, device=CPU)
        with pytest.raises(ValueError, match="slope path"):
            bt.backtest_space(port, estimators=(est,))
    with pytest.raises(ValueError, match="every banked pair"):
        bt.backtest_paths(port, "expanding", estimator="fwl:c2", device=CPU)
    with pytest.raises(KeyError, match="union"):
        bt.backtest_paths(port, "expanding", estimator="fwl:zzz", device=CPU)


def test_malformed_inputs_rejected_loudly(banks):
    port, _, (y, x, masks) = banks
    with pytest.raises(ValueError, match="expanding.*rolling"):
        bt.parse_scheme("weekly")
    with pytest.raises(ValueError, match="W >= 1"):
        bt.parse_scheme("rolling0")
    with pytest.raises(ValueError, match="route"):
        bt.resolve_backtest_route("bogus")
    with pytest.raises(ValueError, match=">= 2"):
        bt.resolve_quantiles(1)
    with pytest.raises(ValueError, match="repeat"):
        bt.resolve_schemes("expanding,expanding")
    with pytest.raises(ValueError, match="unknown backtest sink"):
        bt.resolve_backtest_sink_name("bogus")
    with pytest.raises(ValueError, match="weightings"):
        BacktestSpace(schemes=("expanding",), sets=("m2",), universes=("All",),
                      weightings=("equal",))
    with pytest.raises(ValueError, match=">= 2"):
        bt.backtest_space(port, n_quantiles=1)
    with pytest.raises(ValueError, match="weights_var"):
        bt.run_backtest(port, x, y, masks, space=bt.backtest_space(port, schemes="expanding",
                                                                   weightings=("vw",)),
                        device=CPU)
    with pytest.raises(KeyError, match="universe masks"):
        bt.run_backtest(port, x, y, {"All": masks["All"]},
                        space=bt.backtest_space(port, schemes="expanding", weightings=("ew",)),
                        device=CPU)
    with pytest.raises(ValueError, match="parquet"):
        bt.resolve_backtest_sink("parquet")


def test_backtest_knobs_resolve_arg_over_env_over_default(monkeypatch):
    for var in ("FMRP_BACKTEST_ROUTE", "FMRP_BACKTEST_SCHEMES", "FMRP_BACKTEST_QUANTILES",
                "FMRP_BACKTEST_SINK"):
        monkeypatch.delenv(var, raising=False)
    assert bt.resolve_backtest_route(None) == "auto"
    assert bt.resolve_schemes(None) == (("expanding", None), ("rolling120", 120))
    assert bt.resolve_quantiles(None) == 10
    assert bt.resolve_backtest_sink_name(None) == "frame"
    monkeypatch.setenv("FMRP_BACKTEST_ROUTE", "refit")
    monkeypatch.setenv("FMRP_BACKTEST_SCHEMES", "rolling24")
    monkeypatch.setenv("FMRP_BACKTEST_QUANTILES", "5")
    monkeypatch.setenv("FMRP_BACKTEST_SINK", "metrics")
    assert bt.resolve_backtest_route(None) == "refit"
    assert bt.resolve_schemes(None) == (("rolling24", 24),)
    assert bt.resolve_quantiles(None) == 5
    assert bt.resolve_backtest_sink_name(None) == "metrics"
    assert isinstance(bt.resolve_backtest_sink(None), bt.MetricsSink)
    assert bt.resolve_backtest_route("scan") == "scan"
    assert bt.resolve_schemes("expanding") == (("expanding", None),)
    assert bt.resolve_quantiles(3) == 3
    assert bt.resolve_backtest_sink_name("frame") == "frame"
    monkeypatch.setenv("FMRP_BACKTEST_ROUTE", "nope")
    with pytest.raises(ValueError, match="route"):
        bt.resolve_backtest_route(None)


def test_backtest_entry_points_default_to_the_gpu(banks, monkeypatch):
    port, _, (y, x, masks) = banks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.backtest_paths(port, "expanding")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.run_backtest(port, x, y, masks, space=bt.backtest_space(port, weightings=("ew",)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.series_inference(np.ones(5))


# -- the guard contract ------------------------------------------------------

def test_backtest_rules_match_jax_and_fire_on_a_planted_frame(banks):
    port, _, (y, x, masks) = banks
    frame, _ = bt.run_backtest(port, x, y, masks,
                               space=bt.backtest_space(port, schemes="expanding",
                                                       weightings=("ew",), n_quantiles=5,
                                                       min_obs=20),
                               min_months=5, device=CPU)
    rules, ref_rules = contracts.backtest_rules(), jax_contracts.backtest_rules()
    assert [(r.name, r.severity) for r in rules] == [(r.name, r.severity) for r in ref_rules]
    assert contracts.evaluate(rules, frame) == []

    # evaluation stops at the first blocking violation: plant one fault a frame
    for col, value, rule in (("oos_r2", 1.5, "backtest.oos_r2_bound"),
                             ("ic_mean", -1.2, "backtest.ic_band"),
                             ("rank_ic_mean", 1.01, "backtest.rank_ic_band"),
                             ("spread_turnover", 1.3, "backtest.turnover_band"),
                             ("n_months", None, "backtest.columns")):
        planted = frame.copy()
        if value is None:
            planted = planted.drop(columns=[col])
        else:
            planted.loc[1, col] = value
        got = [(v.rule, v.severity) for v in contracts.evaluate(rules, planted)]
        want = [(v.rule, v.severity) for v in jax_contracts.evaluate(ref_rules, planted)]
        assert got == want == [(rule, "quarantine")], col
        audit = contracts.AuditRecord()
        with pytest.warns(contracts.GuardWarning, match="quarantined"):
            assert contracts.screen_artifact("backtest", planted, rules, audit) is None
        assert audit.quarantined == ["backtest"]


# -- the command line --------------------------------------------------------

def test_cli_backtest_flags_parse_and_estimator_stays_refused(monkeypatch, capsys):
    from fm_returnprediction_tpu_torch import pipeline as port_pipeline

    seen = {}

    class Stop(Exception):
        pass

    def fake_run_pipeline(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(port_pipeline, "run_pipeline", fake_run_pipeline)
    with pytest.raises(Stop):
        port_pipeline._main(["--synthetic", "--device", "cpu", "--backtest-schemes",
                             "expanding,rolling36", "--backtest-route", "refit",
                             "--backtest-quantiles", "5", "--backtest-sink", "topk"])
    assert seen["make_backtest"] and (seen["backtest_schemes"], seen["backtest_route"],
                                      seen["backtest_quantiles"], seen["backtest_sink"]) == \
        ("expanding,rolling36", "refit", 5, "topk")
    with pytest.raises(Stop):
        port_pipeline._main(["--synthetic", "--device", "cpu", "--backtest"])
    assert seen["make_backtest"] and seen["backtest_sink"] is None
    # --specgrid-estimator is ported: it reaches the backtest stage too, as
    # in the reference (the pipeline passes it to run_backtest_scenarios)
    with pytest.raises(Stop):
        port_pipeline._main(["--synthetic", "--device", "cpu", "--backtest",
                             "--specgrid-estimator", "fwl:c0"])
    assert seen["make_backtest"] and seen["make_specgrid"]
    assert seen["specgrid_estimator"] == "fwl:c0"
    for argv in (["--backtest-route", "bogus"], ["--backtest-sink", "bogus"],
                 ["--backtest", "--replica-mode", "fiber"]):
        with pytest.raises(SystemExit) as exc:
            port_pipeline._main(["--synthetic", "--device", "cpu"] + argv)
        assert exc.value.code == 2
    assert "error:" in capsys.readouterr().err
