"""K2 past 32 predictor columns, the port vs the JAX package.

The Gram kernel (``csrc/gram.cu``) takes a union of any width, as the
Pallas kernel ``ops/gram_pallas.py::gram_contract_pallas`` does; this file
holds the CPU's view of that branch:

- the plain version (``specgrid.grams.contract_spec_grams_plain``, what a
  CPU tensor runs) against the Pallas kernel in interpret mode at P = 33,
  40, 64 and 100, float64 at 1e-12 and float32 at 1e-5 of each (spec, month)
  block's largest entry, with and without row weights, counts exact; and
  on bfloat16 operands at P = 40, held as ``chip_smoke.check_gram`` holds
  the bf16 kernel: the Pallas kernel within 1e-5 of the float64 sums of
  the same bf16 terms, the plain version within 1e-5 of the Pallas kernel
  plus its own gap to those sums;
- the kernel's column words (``selection_words``: ⌈P/32⌉ 32-bit words a
  spec) decode back to the selector, and the launch cut
  (``gram_spec_chunk``) is at least one spec however wide the union, the
  whole batch for float64 and for every operand type past 32 columns;
- ``run_spec_grid`` on a 40-column union and an FWL cell with 20 controls
  from it against the JAX functions at float64, at the card-vs-CPU pins
  of ``PERF.md`` §3: 1e-8 of ``max(|b|, 1)``, NaN patterns and counts
  equal; and on a 430-column union, past one float64 launch's reach;
- one launch's reach of each operand type's one-launch kernel
  (``gram_launch_fits``: 848 float32 columns at 9 specs, 847 with row
  weights, 850 at one spec; 424 float64, 1,367 bfloat16), and that every
  type's tile route (``GRAM_TILE_FROM``, ``tests/test_torch_gram_tiles.py``)
  starts within it: every width is one launch of some kernel;
- the pre-pass's plain version (``gram_fold_plain``) against a numpy
  reading of the kernel's validity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.ops.gram_pallas import gram_contract_pallas
from fm_returnprediction_tpu.specgrid import estimators as jest
from fm_returnprediction_tpu.specgrid.solve import run_spec_grid as jax_run_spec_grid
from fm_returnprediction_tpu.specgrid.specs import Spec as JaxSpec
from fm_returnprediction_tpu.specgrid.specs import SpecGrid as JaxSpecGrid
from fm_returnprediction_tpu_torch.specgrid import grams
from fm_returnprediction_tpu_torch.specgrid.estimators import (
    parse_estimator,
    run_estimator_grid_weights,
)
from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid
from fm_returnprediction_tpu_torch.specgrid.specs import Spec, SpecGrid
from torch_threads import one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.torch_port

PIN = 1e-8   # card vs CPU, and port vs reference, at float64 (PERF.md §3)


def _contraction_inputs(p: int, dtype, weighted: bool, t=4, n=300, s=5, seed=0):
    rng = np.random.default_rng(seed + p)
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < 0.05] = np.nan
    x[:, 7, p - 1] = np.nan                     # a non-finite column past the first word
    y = rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.1] = np.nan
    valid = rng.random((s, t, n)) > 0.3
    col_sel = rng.random((s, p)) > 0.5
    col_sel[0] = False
    col_sel[0, 0] = True                        # one column of the first word
    col_sel[1] = False
    col_sel[1, p - 1] = True                    # one column of the last word
    col_sel[-1] = True                          # the whole union
    rw = np.where(rng.random((t, n)) < 0.6, 0.5 + 3.0 * rng.random((t, n)), 0.0) \
        if weighted else None
    center = np.nanmean(x, axis=1)
    return [a if a is None or a.dtype == bool else a.astype(dtype)
            for a in (y, x, valid, col_sel, center, rw)]


def _block_scale(stats):
    gram, moment, n, ysum, yy = (np.asarray(a, np.float64) for a in stats)
    return np.maximum(np.maximum.reduce([
        np.abs(gram).max(axis=(-1, -2)), np.abs(moment).max(axis=-1),
        np.abs(n), np.abs(ysum), np.abs(yy)]), 1.0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("p", [33, 40, 64, 100])
def test_plain_version_matches_the_pallas_kernel(p, dtype, rtol, weighted):
    y, x, valid, col_sel, center, rw = _contraction_inputs(p, dtype, weighted)
    want = gram_contract_pallas(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(col_sel),
        jnp.asarray(center), None if rw is None else jnp.asarray(rw),
        block_n=128, interpret=True)
    t = torch.from_numpy
    got = grams.contract_spec_grams_plain(
        t(y), t(x), t(valid), t(col_sel), None, t(center),
        row_weights=None if rw is None else t(rw))
    assert got[0].shape == (col_sel.shape[0], x.shape[0], p + 1, p + 1)
    scale = _block_scale(want)
    for name, g, w in zip(("gram", "moment", "n", "ysum", "yy"), got, want):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        if name == "n" and not weighted:
            np.testing.assert_array_equal(g, w)
            continue
        s = scale.reshape(scale.shape + (1,) * (g.ndim - 2))
        assert np.all(np.abs(g - w) <= rtol * s), (name, float(np.max(np.abs(g - w) / s)))


def _worst_to_block_max(got, want, scale):
    """The largest difference of two sets of stats, each relative to its
    (spec, month) block's scale."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        sc = scale.reshape(scale.shape + (1,) * (g.ndim - 2))
        worst = max(worst, float(np.max(np.abs(g - w) / sc)))
    return worst


def test_bf16_plain_version_matches_the_pallas_kernel():
    """bfloat16 operands at P = 40 (0/1 weights: the Pallas kernel forms
    its weighted rows in bfloat16, exact only for 0/1): the same bf16 x,
    y and center into both, float32 sums on both sides."""
    y, x, valid, col_sel, center, _ = _contraction_inputs(40, np.float32, False)
    bf = torch.bfloat16
    yb, xb, cb = (torch.from_numpy(a).to(bf) for a in (y, x, center))
    as_jax = lambda a: jnp.asarray(a.float().numpy(), jnp.bfloat16)  # noqa: E731 exact
    want = gram_contract_pallas(as_jax(yb), as_jax(xb), jnp.asarray(valid),
                                jnp.asarray(col_sel), as_jax(cb), None, block_n=128,
                                interpret=True)
    t = torch.from_numpy
    got = grams.contract_spec_grams_plain(yb, xb, t(valid), t(col_sel), None, cb)
    assert got[0].dtype == torch.float32
    # the float64 sums of the same bf16 terms: x − c rounded to bf16 as both form it
    exact = grams.contract_spec_grams_plain(
        yb.double(), (xb - cb[:, None, :]).double(), t(valid), t(col_sel), None,
        torch.zeros(cb.shape, dtype=torch.float64))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    scale = _block_scale(want)
    pallas_exact = _worst_to_block_max(want, exact, scale)
    plain_exact = _worst_to_block_max(got, exact, scale)
    assert pallas_exact <= 1e-5, pallas_exact
    assert _worst_to_block_max(got, want, scale) <= 1e-5 + plain_exact


@pytest.mark.parametrize("p", [0, 1, 31, 32, 33, 40, 64, 100])
def test_selection_words_hold_every_column(p):
    rng = np.random.default_rng(p)
    col_sel = torch.from_numpy(rng.random((6, p)) > 0.5)
    if p:
        col_sel[0, -1] = True
        col_sel[1] = True
    words = grams.selection_words(col_sel)
    assert words.dtype == torch.int32 and words.shape == (6, max(1, -(-p // 32)))
    bits = (words.numpy().astype(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits.reshape(6, -1)[:, :p].astype(bool), col_sel.numpy())
    assert not bits.reshape(6, -1)[:, p:].any()


ONE = grams.GRAM_ONE_LAUNCH_SPECS


@pytest.mark.parametrize("p, chunk", [(14, 60), (40, ONE), (64, ONE), (100, ONE), (125, ONE),
                                      (126, ONE), (300, ONE)])
def test_launch_cut_takes_at_least_one_spec(p, chunk):
    assert grams.gram_spec_chunk(p) == chunk


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 14, 32, 33, 40, 64, 100, 300])
def test_launch_cut_per_operand_type(p, dtype):
    """float32 (and no dtype) and bfloat16 up to 32 columns cut at 8192
    block entries; float64 at any width and every operand type past 32
    columns take the whole batch in one launch."""
    chunk = grams.gram_spec_chunk(p, dtype=dtype)
    if dtype == torch.float64 or p > 32:
        assert chunk == grams.GRAM_ONE_LAUNCH_SPECS
    else:
        assert chunk == grams.gram_spec_chunk(p) == max(1, 8192 // ((p + 2) * (p + 3) // 2))
    with pytest.raises(TypeError):
        grams.gram_spec_chunk(p, dtype)


def _wide_panel(t=36, n=240, p=40, seed=5):
    """A 40-column union: Table 2's shapes widened (the first 3, the first
    7 and every column), two universes; and ``y`` loading on a few
    columns so the slopes are away from zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < 0.02] = np.nan
    beta = np.zeros(p)
    beta[[0, 3, 9, 25, 39]] = [0.5, -0.3, 0.2, 0.4, -0.25]
    y = np.nansum(x * beta, axis=-1) + rng.standard_normal((t, n))
    masks = {"all": np.ones((t, n), bool), "big": rng.random((t, n)) > 0.2}
    names = tuple(f"c{i}" for i in range(p))
    shapes = [(f"m{k}|{u}", names[:w], u) for k, w in enumerate((3, 7, p)) for u in masks]
    return y, x, masks, names, shapes


def _close(got, want, what):
    g, w = np.asarray(got, float), np.asarray(want, float)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    fin = np.isfinite(w)
    gap = np.abs(g[fin] - w[fin]) / np.maximum(np.abs(w[fin]), 1.0)
    assert gap.max(initial=0.0) <= PIN, (what, float(gap.max(initial=0.0)))


def _results_close(got, want, what):
    for name in ("coef", "tstat", "nw_se", "mean_r2", "mean_n", "slopes"):
        _close(getattr(got, name), getattr(want, name), f"{what} {name}")
    for name in ("n_months", "suspect_months", "month_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=f"{what} {name}")


def test_wide_spec_grid_matches_jax():
    """``run_spec_grid`` over a 40-column union: one contraction of every
    spec (the whole union in the widest), the port's positional call as
    the reference's."""
    y, x, masks, names, shapes = _wide_panel()
    grid = SpecGrid(tuple(Spec(n, c, u) for n, c, u in shapes), union=names)
    jgrid = JaxSpecGrid(tuple(JaxSpec(n, c, u) for n, c, u in shapes), union=names)
    want = jax_run_spec_grid(y, x, masks, jgrid)
    t = torch.from_numpy
    got = run_spec_grid(t(y), t(x), {k: t(m) for k, m in masks.items()}, grid, True, None)
    assert got.coef.shape == (len(shapes), len(names))
    assert tuple(got.referee_specs) == tuple(want.referee_specs)
    _results_close(got, want, "run_spec_grid P=40")
    assert np.isfinite(got.coef[-1]).all()


def test_wide_fwl_cell_with_20_controls_matches_jax():
    """An FWL cell whose 20 controls are union columns 20..39, its
    predictors the first 3 and 7: the contraction selects up to 27
    columns of a 40-column union."""
    y, x, masks, names, shapes = _wide_panel(seed=6)
    shapes = [s for s in shapes if len(s[1]) < len(names)]
    grid = SpecGrid(tuple(Spec(n, c, u) for n, c, u in shapes), union=names)
    jgrid = JaxSpecGrid(tuple(JaxSpec(n, c, u) for n, c, u in shapes), union=names)
    est = "fwl:" + "+".join(names[20:])
    t = torch.from_numpy
    got, disc = run_estimator_grid_weights(parse_estimator(est), t(y), t(x),
                                           {k: t(m) for k, m in masks.items()}, grid,
                                           ("reference",))
    want, jdisc = jest.run_estimator_grid_weights(jest.parse_estimator(est), y, x, masks,
                                                  jgrid, ("reference",))
    _results_close(got["reference"], want["reference"], "fwl P=40")
    np.testing.assert_array_equal(disc["deficient_months"], jdisc["deficient_months"])
    assert np.isfinite(got["reference"].coef[:, :3]).all()


# one launch's reach at 9 specs of the one-launch kernels (csrc/gram.cu):
# (dtype, row weights) -> the widest union; every operand type takes the
# tile-pair kernel before it
OLD_REACH = {(torch.float64, False): 424, (torch.float64, True): 423,
             (torch.float32, False): 848, (torch.float32, True): 847,
             (torch.bfloat16, False): 1367, (torch.bfloat16, True): 622}


@pytest.fixture
def one_launch_only(monkeypatch):
    """No call takes the tile route: ``gram_launch_fits`` then says what the
    one-launch kernels alone reach."""
    for dtype in list(grams.GRAM_TILE_FROM):
        monkeypatch.setitem(grams.GRAM_TILE_FROM, dtype, 10**9)


@pytest.mark.parametrize("dtype, weighted", list(OLD_REACH))
def test_one_launch_reach_of_each_operand_type(dtype, weighted, one_launch_only):
    """The one-launch kernels' reach at 9 specs, as ``gram_launch_fits``
    replicates their smallest shared-memory layout: one launch at the
    reach, none a column past it; the tile route (the real crossover)
    starts within the reach, so every width is one launch of some kernel."""
    reach = OLD_REACH[(dtype, weighted)]
    assert grams.gram_launch_fits(reach, dtype, 9, weighted)
    assert not grams.gram_launch_fits(reach + 1, dtype, 9, weighted)
    assert grams.gram_tile_plan(reach + 1, dtype, 9) is None


def test_tile_route_starts_within_the_reach():
    """Every crossover is within its one-launch kernel's reach."""
    for (dtype, weighted), reach in OLD_REACH.items():
        assert 101 <= grams.GRAM_TILE_FROM[dtype] <= reach + 1
        for p in (reach, reach + 1, 4000):
            assert grams.gram_launch_fits(p, dtype, 9, weighted)
            assert grams.gram_tile_plan(p, dtype, 9) is not None


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("specs, reach", [(1, 850), (2, 848), (61, 848)])
def test_float32_reach_follows_the_spec_count(specs, reach, weighted, one_launch_only):
    """float32's smallest block holds the two specs a task of 32 tiles can
    touch, so one spec reaches two columns further (one less with row
    weights); one launch takes the reach and not a column past it."""
    reach -= weighted
    assert grams.gram_launch_fits(reach, torch.float32, specs, weighted)
    assert not grams.gram_launch_fits(reach + 1, torch.float32, specs, weighted)


def _wide_inputs(t, n, p, s, dtype, weighted, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p)) * 2.0
    x[rng.random(x.shape) < 0.002] = np.nan
    x[:, 5, p - 1] = np.inf                      # a non-finite entry in the last column
    x[:, 9, 0] = np.nan                          # and in the first
    y = rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.05] = np.nan
    valid = rng.random((s, t, n)) > 0.3
    col_sel = rng.random((s, p)) > 0.5
    col_sel[0] = False
    col_sel[0, 0] = True
    col_sel[1] = False
    col_sel[1, p - 1] = True
    col_sel[-1] = True
    rw = (np.where(rng.random((t, n)) < 0.6, 0.5 + 3.0 * rng.random((t, n)), 0.0)
          if weighted else None)
    to = (lambda a: torch.from_numpy(a).to(dtype))  # noqa: E731
    x_t = to(x)
    return (to(y), x_t, torch.from_numpy(valid).to(torch.uint8), torch.from_numpy(col_sel),
            grams.shared_center(x_t), None if rw is None else to(rw))


def test_fold_plain_version_is_the_kernels_validity():
    """The pre-pass's plain version: valid, finite y and no selected column
    non-finite, column by column in numpy; an unselected non-finite column
    leaves the row valid."""
    y, x, valid, col_sel, _, _ = _wide_inputs(3, 120, 70, 5, torch.float64, False, seed=4)
    got = grams.gram_fold_plain(y, x, valid, col_sel).numpy()
    xn, yn, cs = x.numpy(), y.numpy(), col_sel.numpy()
    want = valid.numpy().astype(bool) & np.isfinite(yn)[None]
    for s in range(cs.shape[0]):
        want[s] &= np.isfinite(xn[:, :, cs[s]]).all(-1)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got.astype(bool), want)
    assert not want[0].all() and want[0].sum() > want[-1].sum()


@pytest.mark.parametrize("p", [430, 200])
def test_spec_grid_past_one_launch_matches_jax(one_thread, p):
    """``run_spec_grid`` over a union past the tile-pair kernel's float64
    crossover (on the card one launch of it; 430 columns was past the
    one-launch kernel's reach; here the CPU's plain version) against the
    JAX function at float64: 3 specs over the first 3, half and every
    column, 6 months (the grid's minimum set to 4)."""
    assert p >= grams.GRAM_TILE_FROM[torch.float64]
    t, n = 6, 600
    rng = np.random.default_rng(21)
    x = rng.standard_normal((t, n, p))
    x[np.arange(t)[:, None], rng.integers(0, n, (t, 12)), rng.integers(0, p, (t, 12))] = np.nan
    beta = np.zeros(p)
    beta[[0, 2, p // 4, 2 * p // 3, p - 1]] = [0.5, -0.3, 0.2, 0.4, -0.25]
    y = np.nansum(x * beta, axis=-1) + rng.standard_normal((t, n))
    masks = {"all": np.ones((t, n), bool)}
    names = tuple(f"c{i}" for i in range(p))
    shapes = [(f"m{w}", names[:w], "all") for w in (3, p // 2, p)]
    grid = SpecGrid(tuple(Spec(nm, c, u) for nm, c, u in shapes), union=names, min_months=4)
    jgrid = JaxSpecGrid(tuple(JaxSpec(nm, c, u) for nm, c, u in shapes), union=names,
                        min_months=4)
    want = jax_run_spec_grid(y, x, masks, jgrid)
    t_ = torch.from_numpy
    got = run_spec_grid(t_(y), t_(x), {k: t_(m) for k, m in masks.items()}, grid, True, None)
    assert got.coef.shape == (3, p)
    assert tuple(got.referee_specs) == tuple(want.referee_specs)
    _results_close(got, want, f"run_spec_grid P={p}")
    assert np.isfinite(got.coef[-1]).all()
