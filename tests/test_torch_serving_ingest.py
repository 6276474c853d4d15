"""The port's serving-state month ingest vs the JAX package's, at float64.

Same seeded numpy panel on both sides (120 months × 80 firms × 3
predictors, the reference's serving test shape):

- months 90–119 ingested one at a time into a ``solver="normal"`` state
  match a full normal-route rebuild and the batch forecast at the
  reference's own pins (coefficients rtol 1e-9 / atol 1e-12, support
  bounds 1e-12, Grams 1e-9 / 1e-12), and the JAX package's ingested state
  at the same pins;
- a month arriving in two disjoint pieces merges to the one-shot ingest;
- a month with no returns stays quotable, and its later merge upgrades it;
- ``validate_cross_section`` rejects each planted fault with the same
  ``cs.*`` rule name in both packages, and passes a clean month;
- ``_merge_bounds`` equals JAX's on ±inf sentinels;
- ``build_serving_state(solver=)`` takes each solver and a saved state's
  solver name loads in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.guard import checks as jax_checks
from fm_returnprediction_tpu.guard import contracts as jax_contracts
from fm_returnprediction_tpu.models.forecast import rolling_er_forecast as jax_forecast
from fm_returnprediction_tpu.resilience.errors import IngestRejectedError as JaxRejected
from fm_returnprediction_tpu.serving.ingest import ingest_month as jax_ingest
from fm_returnprediction_tpu.serving.ingest import validate_cross_section as jax_validate
from fm_returnprediction_tpu.serving.state import ServingState as JaxState
from fm_returnprediction_tpu.serving.state import _merge_bounds as jax_merge_bounds
from fm_returnprediction_tpu.serving.state import build_serving_state as jax_build
from fm_returnprediction_tpu_torch.guard import checks as port_checks
from fm_returnprediction_tpu_torch.guard import contracts as port_contracts
from fm_returnprediction_tpu_torch.models.forecast import rolling_er_forecast
from fm_returnprediction_tpu_torch.resilience.errors import IngestRejectedError
from fm_returnprediction_tpu_torch.serving.ingest import ingest_month, validate_cross_section
from fm_returnprediction_tpu_torch.serving.state import _merge_bounds, build_serving_state

pytestmark = pytest.mark.torch_port

WINDOW, MIN_PERIODS = 40, 20
T0 = 90
T = torch.from_numpy


def _make_panel(seed=2015, t=120, n=80, p=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    y = x @ (0.05 * np.array([1.0, -0.5, 0.25])[:p]) + 0.02 * rng.standard_normal((t, n))
    mask = rng.random((t, n)) > 0.1
    y = np.where(mask, y, np.nan)
    x = np.where(mask[..., None], x, np.nan)
    holes = rng.random((t, n)) < 0.05          # incomplete predictors inside the mask
    x[..., 0] = np.where(holes & mask, np.nan, x[..., 0])
    return y, x, mask


@pytest.fixture(scope="module")
def panel():
    return _make_panel()


def _port_state(y, x, mask, solver="normal"):
    return build_serving_state(T(y), T(x), T(mask), window=WINDOW,
                               min_periods=MIN_PERIODS, solver=solver)


def _pinned(got, want):
    """The reference's ingest pins (tests/test_serving.py)."""
    for leaf in ("coef", "slopes_bar", "intercept_bar"):
        np.testing.assert_allclose(getattr(got, leaf), getattr(want, leaf), rtol=1e-9,
                                   atol=1e-12, equal_nan=True, err_msg=leaf)
    for leaf in ("x_lo", "x_hi"):
        np.testing.assert_allclose(getattr(got, leaf), getattr(want, leaf), rtol=1e-12,
                                   equal_nan=True, err_msg=leaf)
    for leaf in ("gram", "moment", "ysum", "yy"):
        np.testing.assert_allclose(getattr(got, leaf), getattr(want, leaf), rtol=1e-9,
                                   atol=1e-12, err_msg=leaf)
    np.testing.assert_array_equal(got.n_obs, want.n_obs)
    np.testing.assert_array_equal(got.month_valid, want.month_valid)
    np.testing.assert_array_equal(got.months, want.months)


@pytest.fixture(scope="module")
def ingested(panel):
    y, x, mask = panel
    port = _port_state(y[:T0], x[:T0], mask[:T0])
    ref = jax_build(y[:T0], x[:T0], mask[:T0], window=WINDOW, min_periods=MIN_PERIODS,
                    solver="normal")
    for tt in range(T0, y.shape[0]):
        month = np.datetime64(tt, "M")
        port = ingest_month(port, y[tt], x[tt], mask[tt], month, device="cpu")
        ref = jax_ingest(ref, y[tt], x[tt], mask[tt], month)
    return port, ref


def test_ingest_matches_full_normal_rebuild(panel, ingested):
    y, x, mask = panel
    state, _ = ingested
    full = rolling_er_forecast(T(y), T(x), T(mask), window=WINDOW,
                               min_periods=MIN_PERIODS, solver="normal")
    np.testing.assert_allclose(state.slopes_bar, full.slopes_bar.numpy(), rtol=1e-9,
                               atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(state.intercept_bar, full.intercept_bar.numpy(), rtol=1e-9,
                               atol=1e-12, equal_nan=True)
    rebuilt = _port_state(y, x, mask)
    assert rebuilt.solver == state.solver == "normal"
    _pinned(state, rebuilt)


def test_ingest_matches_jax_ingest(ingested):
    port, ref = ingested
    _pinned(port, ref)


def test_split_month_merges_to_one_shot_ingest(panel):
    y, x, mask = panel
    base = _port_state(y[:T0], x[:T0], mask[:T0])
    month = np.datetime64(T0, "M")
    half = y.shape[1] // 2
    m_a, m_b = mask[T0].copy(), mask[T0].copy()
    m_a[half:] = False
    m_b[:half] = False
    two = ingest_month(base, np.where(m_a, y[T0], np.nan), x[T0], m_a, month, device="cpu")
    two = ingest_month(two, np.where(m_b, y[T0], np.nan), x[T0], m_b, month, device="cpu")
    one = ingest_month(base, y[T0], x[T0], mask[T0], month, device="cpu")
    assert two.n_months == one.n_months == T0 + 1
    np.testing.assert_allclose(two.gram, one.gram, rtol=1e-12)
    np.testing.assert_allclose(two.moment, one.moment, rtol=1e-12)
    np.testing.assert_array_equal(two.n_obs, one.n_obs)
    np.testing.assert_allclose(two.coef, one.coef, rtol=1e-9, atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(two.x_lo, one.x_lo, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(two.x_hi, one.x_hi, rtol=1e-12, equal_nan=True)


def test_month_without_returns_stays_quotable(panel):
    y, x, mask = panel
    base = _port_state(y, x, mask, solver="qr")
    n, p = x.shape[1], x.shape[2]
    x_new = np.random.default_rng(3).standard_normal((n, p))
    y_new = np.full(n, np.nan)
    month = np.datetime64(y.shape[0], "M")
    state = ingest_month(base, y_new, x_new, np.ones(n, bool), month, device="cpu")
    want = jax_ingest(jax_build(y, x, mask, window=WINDOW, min_periods=MIN_PERIODS),
                      y_new, x_new, np.ones(n, bool), month)
    assert not state.month_valid[-1] and state.have_coef()[-1]
    _pinned(state, want)
    rebuilt = _port_state(np.concatenate([y, y_new[None]]), np.concatenate([x, x_new[None]]),
                          np.concatenate([mask, np.ones((1, n), bool)]), solver="qr")
    np.testing.assert_allclose(state.slopes_bar[-1], rebuilt.slopes_bar[-1], rtol=1e-9,
                               atol=1e-12)
    merged = ingest_month(state, x_new @ np.array([0.05, -0.025, 0.0125]), x_new,
                          np.ones(n, bool), month, device="cpu")
    assert merged.month_valid[-1]
    np.testing.assert_array_equal(merged.slopes_bar[-1], state.slopes_bar[-1])


def _faults(state, x, mask):
    n, p = x.shape[1], x.shape[2]
    nan_y = np.full(n, np.nan)
    spiked = x[-1].copy()
    spiked[:, 0] *= 1e20
    inf_y = np.zeros(n)
    inf_y[mask[-1].argmax()] = np.inf
    return {
        "cs.shape": (nan_y, x[-1][:, :p - 1], mask[-1], None),
        "cs.length": (nan_y[:-1], x[-1], mask[-1], None),
        "cs.nan_flood": (nan_y, np.full((n, p), np.nan), np.ones(n, bool), None),
        "cs.y_bounds": (inf_y, x[-1], mask[-1], None),
        "cs.value_bounds": (nan_y, spiked, np.ones(n, bool), None),
        "cs.stale_repeat": (nan_y, x[-1], mask[-1], np.datetime64("2099-01-31", "ns")),
    }


@pytest.mark.parametrize("rule", ["cs.shape", "cs.length", "cs.nan_flood", "cs.y_bounds",
                                  "cs.value_bounds", "cs.stale_repeat"])
def test_rejections_name_the_same_rule(panel, rule):
    y, x, mask = panel
    port_state = _port_state(y, x, mask, solver="qr")
    ref_state = jax_build(y, x, mask, window=WINDOW, min_periods=MIN_PERIODS)
    y_new, x_new, m_new, month = _faults(port_state, x, mask)[rule]
    port_audit, ref_audit = port_contracts.AuditRecord(), jax_contracts.AuditRecord()
    with pytest.raises(IngestRejectedError, match=rule):
        validate_cross_section(port_state, y_new, x_new, m_new, month=month, audit=port_audit)
    with pytest.raises(JaxRejected, match=rule):
        jax_validate(ref_state, y_new, x_new, m_new, month=month, audit=ref_audit)
    assert port_audit.names() == ref_audit.names() == [rule]
    assert [v.severity for v in port_audit.violations] == ["quarantine"]


def test_clean_and_merge_offers_pass(panel):
    y, x, mask = panel
    state = _port_state(y, x, mask, solver="qr")
    n = x.shape[1]
    got = validate_cross_section(state, np.full(n, np.nan), x[-1] + 0.25, mask[-1],
                                 month=np.datetime64("2099-01-31", "ns"))
    assert got[1].dtype == state.dtype
    # the same cross-section re-offered under the state's last label merges
    validate_cross_section(state, np.full(n, np.nan), x[-1], mask[-1], month=state.months[-1])


def test_nonfinite_stats_are_rejected_under_the_guard(panel):
    y, x, mask = panel
    port_state = _port_state(y[:T0], x[:T0], mask[:T0])
    ref_state = jax_build(y[:T0], x[:T0], mask[:T0], window=WINDOW, min_periods=MIN_PERIODS,
                          solver="normal")
    x_bad = x[T0].copy()
    x_bad[mask[T0].argmax(), :] = 1e200      # finite, but x² overflows the Gram
    month = np.datetime64(T0, "M")
    with port_checks.guards(True), pytest.raises(IngestRejectedError, match="cs.nonfinite_stats"):
        ingest_month(port_state, y[T0], x_bad, mask[T0], month, device="cpu")
    with jax_checks.guards(True), pytest.raises(JaxRejected, match="cs.nonfinite_stats"):
        jax_ingest(ref_state, y[T0], x_bad, mask[T0], month)


def test_append_only_and_width_are_enforced(panel):
    y, x, mask = panel
    state = _port_state(y[:T0], x[:T0], mask[:T0])
    with pytest.raises(ValueError, match="append-only"):
        ingest_month(state, y[T0], x[T0], mask[T0], np.datetime64(10, "M"), device="cpu")
    with pytest.raises(ValueError, match="predictors"):
        ingest_month(state, y[T0], x[T0][:, :2], mask[T0], np.datetime64(T0, "M"),
                     device="cpu")


def test_default_device_without_gpu_raises(panel, monkeypatch):
    y, x, mask = panel
    state = _port_state(y[:T0], x[:T0], mask[:T0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest_month(state, y[T0], x[T0], mask[T0], np.datetime64(T0, "M"))


def test_merge_bounds_matches_jax():
    inf = np.inf
    lo_a = np.array([-inf, 0.5, -1.0, -inf, 2.0])
    hi_a = np.array([inf, 1.5, 3.0, inf, 2.0])
    lo_b = np.array([-inf, -inf, 0.0, -2.0, 1.0])
    hi_b = np.array([inf, inf, 4.0, 5.0, 2.5])
    got = _merge_bounds(lo_a, hi_a, lo_b, hi_b)
    want = jax_merge_bounds(lo_a, hi_a, lo_b, hi_b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [-inf, 0.5, -1.0, -2.0, 1.0])
    np.testing.assert_array_equal(got[1], [inf, 1.5, 4.0, 5.0, 2.5])


@pytest.mark.parametrize("solver", ["qr", "lstsq", "normal"])
def test_build_state_takes_each_solver(panel, solver, tmp_path):
    y, x, mask = panel
    got = _port_state(y, x, mask, solver=solver)
    want = jax_build(y, x, mask, window=WINDOW, min_periods=MIN_PERIODS, solver=solver)
    _pinned(got, want)
    loaded = JaxState.load(got.save(tmp_path / "state.npz"))
    assert loaded.solver == solver
    np.testing.assert_array_equal(loaded.coef, got.coef)
    fr = jax_forecast(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask), window=WINDOW,
                      min_periods=MIN_PERIODS, solver=solver)
    np.testing.assert_allclose(got.slopes_bar, np.asarray(fr.slopes_bar), rtol=1e-9,
                               atol=1e-12, equal_nan=True)
