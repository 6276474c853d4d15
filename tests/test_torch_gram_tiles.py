"""K2's tile-pair route for wide unions of every operand type, the CPU's view.

Past ``GRAM_TILE_FROM`` columns a float32, float64 or bfloat16 contraction
runs the pre-pass and one launch of the tile-pair kernel (``csrc/gram.cu``,
``gram_f32_tiles_kernel`` / ``gram_dmma_tiles_kernel`` /
``gram_tc_tiles_kernel``), whose walk is the pure-Python plan
``specgrid.grams.gram_tile_plan``. The kernel needs the card; here:

- the plan: its tile pairs cover the upper triangle of the tile grid once
  and, with the entries the kernel writes for each pair, every entry of
  the augmented block once; the intercept lands in the first tile and y in
  the last; the spec groups cover the batch; every call at or below 100
  columns keeps its route and its launch count, float32 keeps its
  one-launch kernel below its crossover, and every operand type takes the
  tile route (one launch) from its crossover at any width up to 4,000
  columns, 1 to 61 specs, with and without row weights;
- a plain emulation of the decomposition: the tile pairs summed in plain
  torch from their two column ranges of x (the center subtracted, bfloat16
  terms rounded as the kernel rounds them), the pre-pass's folded mask and
  the row weights their weights, each pair's entries and their mirrors
  written, against the whole plain contraction (``gram_contract_plain``):
  float64 at 1e-12 of each (spec, month) block's largest entry, float32 at
  1e-5 of it, bfloat16 (float32 sums, as the kernel's) at 1e-5 of the
  float64 sums of the same bfloat16 terms, counts exact under 0/1 weights,
  at P = 129, 425, 921 and 1,001.

The emulation and the plain contractions run with torch on one thread
(``one_thread``): many threads a test process beside the other test
processes made them spin many times longer.
"""

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu_torch.specgrid import grams
from torch_threads import one_thread  # noqa: F401 (a fixture)

pytestmark = [pytest.mark.torch_port, pytest.mark.usefixtures("one_thread")]

TILE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
F32_FROM = grams.GRAM_TILE_FROM[torch.float32]


def tile_writes(plan):
    """The entries the kernel writes for every pair of ``plan``, on or above
    the diagonal of the (P + 2, P + 2) block: integer arrays (pair, row within
    the pair's first tile, column within its second, row, column). A pair
    writes its rectangle within the block (a diagonal pair: its entries on
    or above the diagonal), and each entry's mirror."""
    qe, cols = plan.p + 2, plan.cols
    ij = np.asarray(plan.pairs, np.int32).reshape(-1, 2)
    lo = np.arange(cols, dtype=np.int16)
    k, lr, lc = np.meshgrid(np.arange(len(ij), dtype=np.int16), lo, lo, indexing="ij")
    r, c = ij[k, 0] * cols + lr, ij[k, 1] * cols + lc
    keep = (r < qe) & (c < qe) & (r <= c)
    return k[keep], lr[keep], lc[keep], r[keep], c[keep]


@pytest.mark.parametrize("specs", [1, 3, 9, 61])
@pytest.mark.parametrize("dtype", TILE_DTYPES)
@pytest.mark.parametrize("p", [126, 127, 128, 129, 190, 425, 920, 921, 1001, 4000])
def test_tile_pairs_cover_the_block_once(p, dtype, specs):
    """Every tile pair (I ≤ J) once, row by row; every entry of the
    (P + 2, P + 2) block written by exactly one pair, once (its own entry
    or its mirror); the intercept in tile 0 and y in the last tile; the
    spec groups the fewest of at most ``GRAM_TILE_SPECS``, near equal,
    covering the batch."""
    plan = grams.gram_tile_plan(max(p, grams.GRAM_TILE_FROM[dtype]), dtype, specs)
    qe = plan.p + 2
    assert plan.cols == grams.GRAM_TILE_COLS
    assert plan.tiles == -(-qe // plan.cols) and (plan.tiles - 1) * plan.cols < qe
    k = plan.tiles
    assert plan.pairs == tuple((i, j) for i in range(k) for j in range(i, k))
    pair, _, _, r, c = tile_writes(plan)
    mirror = r < c
    flat = np.concatenate([r * qe + c, (c * qe + r)[mirror]])
    np.testing.assert_array_equal(np.bincount(flat, minlength=qe * qe), 1)
    assert pair[(r == 0) & (c == 0)].tolist() == [0]                  # the intercept's (0, 0)
    assert plan.pairs[-1] == (k - 1, k - 1)
    assert pair[(r == qe - 1) & (c == qe - 1)].tolist() == [len(plan.pairs) - 1]  # y's
    assert 1 <= plan.spec_group <= grams.GRAM_TILE_SPECS
    assert plan.groups == -(-specs // grams.GRAM_TILE_SPECS)
    assert (plan.groups - 1) * plan.spec_group < specs <= plan.groups * plan.spec_group


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [None, torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 14, 32, 33, 40, 64, 100])
def test_route_unchanged_up_to_100_columns(p, dtype, weighted):
    """No call at or below 100 columns takes the tile route: one launch a
    chunk of ``gram_spec_chunk`` specs, no pre-pass, as before."""
    for specs in (1, 3, 9, 61):
        assert grams.gram_tile_plan(p, dtype, specs) is None
        assert grams.gram_launch_fits(p, dtype, specs, weighted)
        chunk = grams.gram_spec_chunk(p, dtype=dtype)
        assert grams.gram_launch_count(p, specs, dtype) == -(-specs // chunk)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("p", sorted({101, 128, F32_FROM - 1, F32_FROM, 424, 425, 848, 849, 920,
                                      2000, 4000}))
def test_float32_takes_the_tile_route_from_its_crossover(p, weighted):
    """float32 below its crossover keeps its one-launch kernel (one launch
    for the whole batch past 32 columns, no pre-pass); from it the tile
    route, one launch at any width, the one-launch kernel's reach (848
    columns) included and past."""
    for specs in (1, 3, 9, 61):
        plan = grams.gram_tile_plan(p, torch.float32, specs)
        assert (plan is None) == (p < F32_FROM)
        assert grams.gram_launch_fits(p, torch.float32, specs, weighted)
        assert grams.gram_launch_count(p, specs, torch.float32) == 1


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", TILE_DTYPES)
def test_wide_unions_take_the_tile_route(dtype, weighted):
    """From the crossover (at least 101 columns, within the one-launch
    kernel's reach below it) every operand type takes the tile route at
    any width up to 4,000 and any spec count from 1 to 61: one launch."""
    start = grams.GRAM_TILE_FROM[dtype]
    assert start >= 101
    for specs in (1, 2, 3, 4, 9, 27, 61):
        below = start - 1
        assert grams.gram_tile_plan(below, dtype, specs) is None
        assert grams.gram_launch_fits(below, dtype, specs, weighted)
        for p in (start, start + 1, 255, 424, 425, 622, 623, 848, 849, 1367, 1368, 2000, 4000):
            plan = grams.gram_tile_plan(p, dtype, specs)
            assert plan is not None and plan.p == p
            assert grams.gram_launch_fits(p, dtype, specs, weighted)
            assert grams.gram_launch_count(p, specs, dtype) == 1


def _tile_inputs(t, n, p, s, dtype, weighted, seed):
    """NaN and infinite entries (one in the first and one in the last
    column), NaN y, a spec of the first column only, one of the last only
    and one of every column; row weights most 0, the rest real-valued."""
    rng = np.random.default_rng(seed + p)
    x = rng.standard_normal((t, n, p)) * 2.0
    x[rng.random(x.shape) < 0.003] = np.nan
    x[:, 5, p - 1] = np.inf
    x[:, 9, 0] = np.nan
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
    center = grams.shared_center(x_t.double()).to(dtype)
    return (to(y), x_t, torch.from_numpy(valid).to(torch.uint8), torch.from_numpy(col_sel),
            center, None if rw is None else to(rw))


def _augmented(y, x, center, sum_dtype):
    """The augmented rows ``[1 | x − c | y]`` (T, N, P + 2) as the kernel
    builds them: non-finite entries 0, ``x − c`` formed in float and
    rounded to the operand type (bfloat16), then in ``sum_dtype``."""
    fin = torch.isfinite(x)
    xc = (x.to(sum_dtype) - center.to(sum_dtype)[:, None, :]).to(x.dtype)
    xz = torch.where(fin, xc, torch.zeros_like(xc)).to(sum_dtype)
    yz = torch.where(torch.isfinite(y), y, torch.zeros_like(y)).to(sum_dtype)
    return torch.cat([torch.ones_like(yz)[..., None], xz, yz[..., None]], dim=-1)


def emulate_tiles(y, x, valid, col_sel, center, row_weights, plan, sum_dtype):
    """The tile-pair decomposition in plain torch: the pre-pass's folded
    mask (times the row weights) weights each pair's second tile, every
    pair's block is summed from its two column ranges at once, and the
    entries ``tile_writes`` names and their mirrors are written, each
    entry of the block once."""
    s, (t, n, p) = col_sel.shape[0], x.shape
    qe = p + 2
    w = grams.gram_fold_plain(y, x, valid, col_sel).to(sum_dtype)
    if row_weights is not None:
        w = w * row_weights.to(sum_dtype)
    aug = torch.zeros((t, n, plan.tiles * plan.cols), dtype=sum_dtype)
    aug[..., :qe] = _augmented(y, x, center, sum_dtype)
    tiles = aug.view(t, n, plan.tiles, plan.cols)
    ij = torch.tensor(plan.pairs).reshape(-1, 2)
    a, b = tiles[:, :, ij[:, 0]], tiles[:, :, ij[:, 1]]            # (T, N, pairs, cols)
    wb = w[..., None, None] * b                                     # (S, T, N, pairs, cols)
    blocks = torch.einsum("tnkr,stnkc->stkrc", a, wb)
    k, lr, lc, r, c = (torch.from_numpy(v.astype(np.int64)) for v in tile_writes(plan))
    vals = blocks[:, :, k, lr, lc]
    out = torch.zeros((s, t, qe * qe), dtype=sum_dtype)
    out[:, :, r * qe + c] = vals
    out[:, :, c * qe + r] = vals
    written = torch.bincount(torch.cat([r * qe + c, (c * qe + r)[r < c]]), minlength=qe * qe)
    assert bool((written == 1).all())
    return out.view(s, t, qe, qe)


def _worst_to_block(got, want):
    scale = want.abs().amax((-1, -2), keepdim=True).clamp_min(1.0)
    return float(((got.double() - want.double()).abs() / scale).max())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", TILE_DTYPES)
@pytest.mark.parametrize("p", [129, 425, 921, 1001])
def test_tile_emulation_matches_the_whole_contraction(p, dtype, weighted, monkeypatch):
    """The emulated tile pairs against the whole plain contraction: float64
    at 1e-12 of each block's largest entry, float32 at 1e-5; bfloat16
    operands summed in float32 (the kernel's sums) at 1e-5 of the float64
    sums of the same terms, the float32 plain version within 1e-5 of them
    too; symmetric, counts exact under 0/1 weights. T = 2, N = 97 (no
    firm-chunk boundary), 4 specs: two spec groups of 2. Below a crossover
    (129 columns for bfloat16, and float32 if its crossover is past it) the
    plan is made as the kernel would walk that width."""
    t, n, s = 2, 97, 4
    y, x, valid, col_sel, center, rw = _tile_inputs(t, n, p, s, dtype, weighted, seed=8)
    monkeypatch.setitem(grams.GRAM_TILE_FROM, dtype, min(p, grams.GRAM_TILE_FROM[dtype]))
    plan = grams.gram_tile_plan(p, dtype, s)
    assert plan is not None and (plan.groups, plan.spec_group) == (2, 2)
    if dtype != torch.bfloat16:
        got = emulate_tiles(y, x, valid, col_sel, center, rw, plan, dtype)
        want = grams.gram_contract_plain(y, x, valid, col_sel, center, rw)
        assert want.dtype == dtype
        assert _worst_to_block(got, want) <= (1e-12 if dtype == torch.float64 else 1e-5)
    else:
        got = emulate_tiles(y, x, valid, col_sel, center, rw, plan, torch.float32)
        exact = emulate_tiles(y, x, valid, col_sel, center, rw, plan, torch.float64)
        plain = grams.gram_contract_plain(y, x, valid, col_sel, center, rw)
        assert plain.dtype == torch.float32
        # the float64 sums of the same bf16 terms, summed as one block
        want = grams.gram_contract_plain(
            y.double(), (x.float() - center.float()[:, None, :]).to(x.dtype).double(),
            valid, col_sel, torch.zeros(center.shape, dtype=torch.float64),
            None if rw is None else rw.double())
        assert _worst_to_block(exact, want) <= 1e-12
        assert _worst_to_block(got, want) <= 1e-5
        assert _worst_to_block(plain, want) <= 1e-5
    assert torch.equal(got, got.transpose(-1, -2))
    if not weighted:
        assert torch.equal(got[:, :, 0, 0], want[:, :, 0, 0].to(got.dtype))
