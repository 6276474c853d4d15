"""The port's Gram solve, spec grid, QR route and FM aggregation vs the JAX
package's.

Same float64 inputs (numpy, seeded) on both sides, on Table 2's 3 × 3 grid.
One month makes two predictors collinear, so every spec holding both is
rank-deficient there and goes to the QR referee on both sides. Per-cell
numbers agree at rtol 1e-8; flags, counts and referee choices exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.ops.fama_macbeth import fama_macbeth as jax_fm
from fm_returnprediction_tpu.specgrid.grams import contract_spec_grams as jax_contract
from fm_returnprediction_tpu.specgrid.solve import (
    run_spec_grid as jax_run_grid,
    solve_spec_stats as jax_solve,
)
from fm_returnprediction_tpu.specgrid.specs import table2_grid as jax_table2_grid
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth
from fm_returnprediction_tpu_torch.panel.characteristics import FACTORS_DICT
from fm_returnprediction_tpu_torch.specgrid.grams import SpecGramStats
from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid, solve_spec_stats
from fm_returnprediction_tpu_torch.specgrid.specs import table2_grid

pytestmark = pytest.mark.torch_port

SUBSETS = ["All stocks", "All-but-tiny stocks", "Large stocks"]


def _close(got, want, what, rtol=1e-8):
    got, want = np.asarray(got, float), np.asarray(want, float)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-13, equal_nan=True,
                               err_msg=what)


@pytest.fixture(scope="module")
def panel():
    grid = table2_grid(FACTORS_DICT, subsets=SUBSETS)
    union = grid.union_predictors
    t, n, p = 40, 160, len(union)
    rng = np.random.default_rng(42)
    x = rng.standard_normal((t, n, p)) * rng.uniform(0.1, 5.0, p)
    x += rng.uniform(-3, 3, p)                       # non-zero column means
    x[rng.random(x.shape) < 0.04] = np.nan
    y = 0.05 * rng.standard_normal((t, n)) + 0.01 * np.nansum(x[:, :, :3], -1)
    y[rng.random(y.shape) < 0.05] = np.nan
    # month 4: log_bm is an exact multiple of log_size → rank-deficient for
    # every model (all three carry both)
    i, j = union.index("log_size"), union.index("log_bm")
    x[4, :, j] = 2.0 * x[4, :, i]
    universes = np.stack([np.ones((t, n), bool), rng.random((t, n)) > 0.3,
                          rng.random((t, n)) > 0.6])
    universes[2, 9, 20:] = False                     # a thin month
    return grid, y, x, universes


def test_table2_grid_matches(panel):
    grid = panel[0]
    ref = jax_table2_grid(FACTORS_DICT, subsets=SUBSETS)
    assert grid.union_predictors == ref.union_predictors
    np.testing.assert_array_equal(grid.column_selector(), ref.column_selector())
    np.testing.assert_array_equal(grid.universe_index(SUBSETS),
                                  ref.universe_index(SUBSETS))


def test_solve_spec_stats_matches(panel):
    grid, y, x, universes = panel
    uidx = grid.universe_index(SUBSETS)
    col_sel = grid.column_selector()
    window = grid.window_masks(y.shape[0])
    stats = jax_contract(jnp.asarray(y), jnp.asarray(x), jnp.asarray(universes),
                         jnp.asarray(uidx), jnp.asarray(col_sel), jnp.asarray(window))
    sel_aug = np.concatenate([np.ones((len(grid), 1), bool), col_sel], axis=1)
    want = jax_solve(stats, jnp.asarray(sel_aug))
    got = solve_spec_stats(
        SpecGramStats(*(torch.from_numpy(np.asarray(a)) for a in stats)),
        torch.from_numpy(sel_aug))
    np.testing.assert_array_equal(got.month_valid.numpy(), np.asarray(want.month_valid))
    np.testing.assert_array_equal(got.suspect.numpy(), np.asarray(want.suspect))
    assert got.suspect.numpy()[:, 4].all()            # the collinear month
    ok = ~np.asarray(want.suspect)
    _close(got.beta.numpy()[ok], np.asarray(want.beta)[ok], "beta")
    _close(got.r2.numpy()[ok], np.asarray(want.r2)[ok], "r2")


def test_run_spec_grid_matches_with_referee(panel):
    grid, y, x, universes = panel
    masks = {nm: universes[k] for k, nm in enumerate(SUBSETS)}
    want = jax_run_grid(jnp.asarray(y), jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in masks.items()},
                        jax_table2_grid(FACTORS_DICT, subsets=SUBSETS))
    got = run_spec_grid(torch.from_numpy(y), torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in masks.items()}, grid)
    assert got.referee_specs == want.referee_specs
    assert len(got.referee_specs) == len(grid)       # month 4 flags every spec
    np.testing.assert_array_equal(got.suspect_months, want.suspect_months)
    for name in ("coef", "tstat", "nw_se", "mean_r2", "mean_n", "n_months",
                 "slopes", "intercept", "r2", "n_obs", "month_valid"):
        _close(getattr(got, name), getattr(want, name), name)


def test_run_spec_grid_without_referee_matches(panel):
    grid, y, x, universes = panel
    x = x.copy()
    x[4] = np.roll(x[4], 3, axis=0)                  # undo the collinearity
    i, j = grid.union_predictors.index("log_size"), grid.union_predictors.index("log_bm")
    x[4, :, j] += 0.5 * np.nan_to_num(x[4, :, i])
    masks = {nm: universes[k] for k, nm in enumerate(SUBSETS)}
    want = jax_run_grid(jnp.asarray(y), jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in masks.items()},
                        jax_table2_grid(FACTORS_DICT, subsets=SUBSETS))
    got = run_spec_grid(torch.from_numpy(y), torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in masks.items()}, grid)
    assert got.referee_specs == want.referee_specs
    for name in ("coef", "tstat", "mean_r2", "mean_n"):
        _close(getattr(got, name), getattr(want, name), name)


def test_qr_fama_macbeth_matches(panel):
    _, y, x, universes = panel
    cols = [0, 1, 2, 5]
    mask = universes[1].copy()
    mask[12, 3:] = False                             # fewer rows than regressors
    cs_w, fm_w = jax_fm(jnp.asarray(y), jnp.asarray(x[:, :, cols]), jnp.asarray(mask),
                        solver="qr")
    cs_g, fm_g = fama_macbeth(torch.from_numpy(y), torch.from_numpy(x[:, :, cols]),
                              torch.from_numpy(mask))
    for name in ("slopes", "intercept", "r2", "n_obs", "month_valid"):
        _close(getattr(cs_g, name).numpy(), getattr(cs_w, name), name)
    for name in ("coef", "tstat", "nw_se", "mean_r2", "mean_n", "n_months"):
        _close(getattr(fm_g, name).numpy(), getattr(fm_w, name), name)
