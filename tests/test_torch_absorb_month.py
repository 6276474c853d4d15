"""The absorb cell that sat past the 1e-8 card-vs-CPU pin at 240 × 1,200.

``run_scenarios(estimators=("absorb:ind",))`` on ``make_smoke_inputs(
n_firms=1200, n_months=240, seed=20140132)``: on the H100 the cell
``Model 3 | All-but-tiny stocks | sub1of2`` came out 1.266e-8 from the CPU
without a suspect month, carried by one month whose equilibrated within
Gram has condition 1.23e7, just under the suspect tier's 1/√eps (6.7e7),
and whose card and CPU Grams differ by 13.5 eps. This file holds, on the
CPU, that the port does what the reference does there:

- the port's absorb transform on that spec's stats and FE cells equals
  the JAX package's on the same numpy inputs at 1e-12 of each block's
  largest entry (no step of the reference is missing);
- the port's float64 solve of the worst month's stats equals the JAX
  package's on the same numpy stats within that month's own bound,
  ``κ · √n · eps`` of the largest slope (κ the equilibrated condition, n
  the rows summed): the bound ``chip_smoke._condition_pin`` holds the cell
  to, where a flat 1e-8 asks for more than the condition allows.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.specgrid.estimators import absorb as jax_absorb
from fm_returnprediction_tpu.specgrid.grams import SpecGramStats as JaxStats
from fm_returnprediction_tpu.specgrid.solve import solve_spec_stats as jax_solve
from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs
from fm_returnprediction_tpu_torch.models.lewellen import MODELS, model_columns
from fm_returnprediction_tpu_torch.pipeline import run_pipeline
from fm_returnprediction_tpu_torch.specgrid.estimators import grid as grid_mod
from fm_returnprediction_tpu_torch.specgrid.estimators import parse_estimator
from fm_returnprediction_tpu_torch.specgrid.estimators.absorb import absorb_transform
from fm_returnprediction_tpu_torch.specgrid.scenarios import subperiod_windows
from fm_returnprediction_tpu_torch.specgrid.solve import solve_spec_stats
from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid

pytestmark = pytest.mark.torch_port

EPS = np.finfo(np.float64).eps
UNIVERSE = "All-but-tiny stocks"


@pytest.fixture(scope="module")
def cell():
    """The cell's transform inputs and transformed stats, recorded as the
    estimator grid passes them on (one spec, the CPU, float64)."""
    base, daily = make_smoke_inputs(n_firms=1200, n_months=240, seed=20140132,
                                    dtype=np.float64)
    res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu",
                       dtype=torch.float64, make_figure=False, make_deciles=False,
                       make_serving=False)
    cols = tuple(model_columns(MODELS[2], res.factors_dict))
    window = subperiod_windows(240, 2)["sub1of2"]
    grid = SpecGrid((Spec("Model 3 | All-but-tiny | sub1of2", cols, UNIVERSE, window=window),),
                    union=cols)
    ind = np.random.default_rng(2016).integers(0, 12, (240, 1200))   # chip_smoke's FE codes
    seen = {}
    transform, solve = grid_mod.absorb_transform, grid_mod.solve_spec_stats

    def transform_spy(stats, sel_aug, n_cells, s_cells, **kw):
        seen["transform"] = (stats, sel_aug, n_cells, s_cells, kw)
        return transform(stats, sel_aug, n_cells, s_cells, **kw)

    def solve_spy(stats, sel_aug, **kw):
        seen["solve"] = (stats, sel_aug)
        return solve(stats, sel_aug, **kw)

    with mock.patch.object(grid_mod, "absorb_transform", transform_spy), \
            mock.patch.object(grid_mod, "solve_spec_stats", solve_spy):
        results, _ = grid_mod.run_estimator_grid_weights(
            parse_estimator("absorb:ind"), res.panel.var("retx"), res.panel.select(list(cols)),
            {UNIVERSE: res.subset_masks[UNIVERSE]}, grid, ("reference",),
            fe_codes={"ind": ind})
    return seen, results["reference"]


def _jax_stats(stats):
    return JaxStats(*(jnp.asarray(a.numpy()) for a in stats))


def _conditions(stats, sel):
    q = stats.gram.shape[-1]
    pick = sel[:, None, :, None] & sel[:, None, None, :]
    g = torch.where(pick, stats.gram, torch.eye(q, dtype=stats.gram.dtype))
    d = torch.rsqrt(torch.diagonal(g, dim1=-2, dim2=-1).clamp_min(1e-300))
    w = torch.linalg.eigvalsh(g * d[..., :, None] * d[..., None, :])
    return (w[..., -1] / w[..., 0]).numpy()


def test_absorb_transform_takes_the_reference_steps(cell):
    seen, result = cell
    stats, sel_aug, n_cells, s_cells, kw = seen["transform"]
    got = absorb_transform(stats, sel_aug, n_cells, s_cells, **kw)[0]
    want = jax_absorb.absorb_transform(_jax_stats(stats), jnp.asarray(sel_aug.numpy()),
                                       jnp.asarray(n_cells.numpy()),
                                       jnp.asarray(s_cells.numpy()), **kw)[0]
    scale = np.maximum(np.abs(np.asarray(want.gram)).max(axis=(-1, -2)), 1.0)
    for name in ("gram", "moment", "n", "yy"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        s = scale.reshape(scale.shape + (1,) * (g.ndim - 2))
        assert np.all(np.abs(g - w) <= 1e-12 * s), name
    assert int(result.suspect_months[0]) == 0          # the cell has no suspect month


def test_worst_month_solve_matches_the_reference_within_its_condition(cell):
    seen, _ = cell
    stats, sel = seen["solve"]
    cond = _conditions(stats, sel)[0]
    valid = (stats.n[0] >= sel[0].sum()).numpy()
    m = int(np.argmax(np.where(valid, cond, 0.0)))
    assert 1e6 < cond[m] < 1.0 / np.sqrt(EPS), cond[m]   # ill-conditioned, yet unflagged
    month = type(stats)(*(a[:, m:m + 1] for a in stats[:5]), stats.center[m:m + 1])
    got = solve_spec_stats(month, sel)[0]
    want = jax_solve(_jax_stats(month), jnp.asarray(sel.numpy()))
    assert not bool(got.suspect[0, 0]) and not bool(np.asarray(want.suspect)[0, 0])
    b, w = got.beta.numpy()[0, 0], np.asarray(want.beta)[0, 0]
    bound = cond[m] * np.sqrt(float(stats.n[0, m])) * EPS
    assert np.abs(b - w).max() <= bound * np.abs(w).max(), (np.abs(b - w).max(), bound)
