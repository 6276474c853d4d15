"""The port's three OLS solvers vs the JAX package's, at float64 on the CPU.

Same seeded numpy panel on both sides: ``monthly_cs_ols`` and
``fama_macbeth`` for ``solver="qr"``, ``"lstsq"`` and ``"normal"`` agree at
rtol 1e-10 with identical month gates and NaN patterns. The panel carries a
near-singular month (exactly P + 1 valid rows, a square design), a skipped
month (fewer rows than regressors) and, in a second case, a predictor that
is NaN in every month (no month runs). ``gram_pinv``/``solve_from_stats``
are held against JAX's on the same sufficient statistics, the guard's
sentinel counters against JAX's on each solver, and an unknown solver
raises in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.guard import checks as jax_checks
from fm_returnprediction_tpu.ops import ols as jax_ols
from fm_returnprediction_tpu.ops.fama_macbeth import fama_macbeth as jax_fama_macbeth
from fm_returnprediction_tpu_torch.guard import checks as port_checks
from fm_returnprediction_tpu_torch.ops import ols
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth

pytestmark = pytest.mark.torch_port

SOLVERS = ("qr", "lstsq", "normal")
T_MONTHS, N_FIRMS, P = 36, 50, 4
NEAR_SINGULAR, SKIPPED = 3, 5


def _panel(case: str, seed: int = 7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T_MONTHS, N_FIRMS, P))
    x[..., 1] *= 40.0                                      # mixed column scales
    beta = np.array([0.3, -0.01, 0.5, 0.2])
    y = 0.1 + x @ beta + rng.normal(scale=0.5, size=(T_MONTHS, N_FIRMS))
    mask = rng.random((T_MONTHS, N_FIRMS)) < 0.9
    mask[NEAR_SINGULAR] = False
    mask[NEAR_SINGULAR, :P + 1] = True                      # square design
    mask[SKIPPED] = False
    mask[SKIPPED, :P] = True                                # n < P + 1
    x[rng.random(x.shape) < 0.02] = np.nan
    y[rng.random(y.shape) < 0.02] = np.nan
    x[NEAR_SINGULAR, :P + 1] = rng.normal(size=(P + 1, P))  # keep its rows complete
    y[NEAR_SINGULAR, :P + 1] = rng.normal(size=P + 1)
    if case == "nan_column":
        x[..., 2] = np.nan
    return y, x, mask


def _close(got, want, what, rtol=1e-10):
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True, err_msg=what)


@pytest.mark.parametrize("case", ["base", "nan_column"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_monthly_cs_ols_matches_jax(solver, case):
    y, x, mask = _panel(case)
    want = jax_ols.monthly_cs_ols(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                                  solver=solver, guard=False)
    got = ols.monthly_cs_ols(torch.from_numpy(y), torch.from_numpy(x),
                             torch.from_numpy(mask), solver=solver, record=False)
    np.testing.assert_array_equal(got.month_valid.numpy(), np.asarray(want.month_valid))
    np.testing.assert_array_equal(got.n_obs.numpy(), np.asarray(want.n_obs))
    for name in ("slopes", "intercept", "r2"):
        _close(getattr(got, name).numpy(), getattr(want, name), f"{solver} {name}")
    valid = got.month_valid.numpy()
    if case == "base":
        assert valid[NEAR_SINGULAR] and not valid[SKIPPED]
        assert got.n_obs.numpy()[NEAR_SINGULAR] == P + 1
    else:
        assert not valid.any()


@pytest.mark.parametrize("case", ["base", "nan_column"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_fama_macbeth_matches_jax(solver, case):
    y, x, mask = _panel(case)
    _, want = jax_fama_macbeth(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                               solver=solver, guard=False)
    _, got = fama_macbeth(torch.from_numpy(y), torch.from_numpy(x),
                          torch.from_numpy(mask), solver=solver)
    for name in ("coef", "tstat", "nw_se", "mean_r2", "mean_n"):
        _close(getattr(got, name).numpy(), getattr(want, name), f"{solver} {name}")
    assert int(got.n_months) == int(want.n_months)
    if case == "nan_column":
        assert np.isnan(got.coef.numpy()).all()


def test_solve_from_stats_matches_jax():
    y, x, mask = _panel("base")
    valid = np.asarray(jax_ols.row_validity(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask)))
    want_stats = jax_ols.sufficient_stats(jnp.asarray(y), jnp.asarray(x), jnp.asarray(valid))
    stats = ols.NormalStats(*(torch.from_numpy(np.asarray(a)) for a in want_stats))
    pinv, gate = ols.gram_pinv(stats)
    want_pinv, want_gate = jax_ols.gram_pinv(want_stats)
    np.testing.assert_array_equal(gate.numpy(), np.asarray(want_gate))
    np.testing.assert_allclose(pinv.numpy(), np.asarray(want_pinv), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(want_pinv)).max())
    for got, want, name in zip(ols.solve_from_stats(stats), jax_ols.solve_from_stats(want_stats),
                               ("slopes", "intercept", "r2", "n", "month_valid")):
        _close(got.numpy(), want, name)


def test_normal_route_overflowed_gram_solves_as_jax_does():
    """torch's SVD raises on a non-finite matrix where JAX's returns: a
    month whose Gram overflowed solves to zero slopes with a NaN R² on
    both sides."""
    y, x, mask = _panel("base")
    x[7, 0, 0] = 1e200                       # x² overflows to inf in the Gram
    want = jax_ols.monthly_cs_ols(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                                  solver="normal", guard=False)
    got = ols.monthly_cs_ols(torch.from_numpy(y), torch.from_numpy(x),
                             torch.from_numpy(mask), solver="normal", record=False)
    assert (got.slopes.numpy()[7] == 0).all() and np.isnan(got.r2.numpy()[7])
    for name in ("slopes", "intercept", "r2"):
        _close(getattr(got, name).numpy(), getattr(want, name), name)


@pytest.mark.parametrize("solver", SOLVERS)
def test_guard_counters_match_jax(solver):
    y, x, mask = _panel("base")
    x[7, 0, 0] = 1e200
    jax_checks.reset()
    port_checks.reset()
    jax_ols.monthly_cs_ols(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                           solver=solver, guard=True)
    with port_checks.guards(True):
        ols.monthly_cs_ols(torch.from_numpy(y), torch.from_numpy(x),
                           torch.from_numpy(mask), solver=solver)
    want, got = jax_checks.drain(), port_checks.drain()
    jax_checks.reset()
    port_checks.reset()
    assert got == want
    if solver == "normal":
        assert got["ols.monthly_cs_ols.gram_nonfinite_entries"] > 0


def test_unknown_solver_raises_in_both_packages():
    y, x, mask = _panel("base")
    with pytest.raises(ValueError, match="Unknown solver"):
        jax_ols.monthly_cs_ols(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask),
                               solver="cholesky", guard=False)
    with pytest.raises(ValueError, match="Unknown solver"):
        ols.monthly_cs_ols(torch.from_numpy(y), torch.from_numpy(x),
                           torch.from_numpy(mask), solver="cholesky")
    with pytest.raises(ValueError, match="Unknown solver"):
        fama_macbeth(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(mask),
                     solver="cholesky")


def test_subset_stacked_masks_equal_per_subset_solves():
    """A stack of masks (S, T, N) over one panel solves each subset as its
    own call would (the stacked reporting route's batched call)."""
    y, x, mask = _panel("base")
    rng = np.random.default_rng(3)
    masks = np.stack([mask, mask & (rng.random(mask.shape) < 0.7)])
    yt, xt = torch.from_numpy(y), torch.from_numpy(x)
    for solver in SOLVERS:
        both = ols.monthly_cs_ols(yt, xt, torch.from_numpy(masks), solver=solver, record=False)
        for s in range(2):
            one = ols.monthly_cs_ols(yt, xt, torch.from_numpy(masks[s]), solver=solver,
                                     record=False)
            for name in one._fields:
                _close(getattr(both, name)[s].numpy(), getattr(one, name).numpy(),
                       f"{solver} {name}[{s}]", rtol=1e-12)
