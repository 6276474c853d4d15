"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need a CUDA device and the CUDA toolkit (the kernels are built
on first use); without a device they skip. On a machine with one GPU:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: float64 at rtol 1e-10 for the rolling family (both sides
difference two cumulative sums, so a small window std under a large running
sum loses digits to cancellation) and 1e-12 of each (spec, month) block's
max-abs entry for the Gram contraction (1e-5 in float32 and for bfloat16
operands, whose plain version forms the same float32 products); the
cumulative moments at 1e-12
(float64) / 1e-5 (float32) of the largest cumulative magnitude (the card's
``torch.cumsum`` scans in another order than the kernel's chunked two-pass
walk) and bit-identical from launch to launch; identical NaN patterns,
exact counts.
"""

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu_torch.ops import rolling
from fm_returnprediction_tpu_torch.specgrid import grams

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _rolling_input(dtype, cuda, t=300, n=257, seed=0, infs=False):
    rng = np.random.default_rng(seed)
    x = 1.0 + 0.3 * rng.standard_normal((t, n))
    x[rng.random(x.shape) < 0.05] = np.nan
    if infs:                                           # +inf and -inf add nothing
        x[rng.random(x.shape) < 0.01] = np.inf
        x[rng.random(x.shape) < 0.01] = -np.inf
    x[:, 3] = np.nan                                   # an all-NaN column
    counts = rng.integers(0, t + 1, n)
    x[np.arange(t)[:, None] >= counts[None, :]] = np.nan
    return torch.tensor(x, dtype=dtype, device=cuda)


@pytest.mark.parametrize("kind", ["sum", "mean", "std"])
@pytest.mark.parametrize("window,mp", [(12, 0), (12, 1), (24, 24), (252, 100), (500, 2)])
def test_rolling_kernel_matches_plain_f64(cuda, kind, window, mp):
    x = _rolling_input(torch.float64, cuda)
    got = rolling.rolling_reduce_cuda(x, window, mp, kind).cpu().numpy()
    want = rolling.rolling_reduce_plain(x, window, mp, kind).cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14, equal_nan=True)


def test_rolling_kernel_f32_close_to_f64(cuda):
    x64 = _rolling_input(torch.float64, cuda)
    got = rolling.rolling_reduce_cuda(x64.float(), 252, 100, "std").double()
    want = rolling.rolling_reduce_plain(x64, 252, 100, "std")
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, equal_nan=True)


def _rolling_limit(x64, kind, window, eps):
    """``4·eps·C`` per element, C the column's cumulative magnitude (the
    variance-level form for std), as ``chip_smoke.rolling_tolerance``."""
    fin = torch.isfinite(x64)
    xz = torch.where(fin, x64, torch.zeros_like(x64))
    c1 = xz.abs().sum(0)[None, :]
    c2 = (xz * xz).sum(0)[None, :]
    cnt = rolling.rolling_reduce_plain(fin.double(), window, 0, "sum").clamp_min(1)
    if kind == "sum":
        return 4 * eps * c1
    if kind == "mean":
        return 4 * eps * c1 / cnt
    w1 = rolling.rolling_reduce_plain(x64, window, 0, "sum").abs()
    return torch.sqrt(4 * eps * (c2 + 2 * w1 * c1 / cnt) / (cnt - 1).clamp_min(1))


@pytest.mark.parametrize("kind", ["sum", "mean", "std"])
@pytest.mark.parametrize("t,n", [(3000, 257), (1024, 2432)])
def test_rolling_kernel_chunks_match_plain(cuda, kind, t, n):
    """Several chunks of the time axis (w=252: 512-row chunks, each warming
    up from 252 rows before its first), f64 at rtol 1e-10 and f32 at
    1e-4·|p| + 4·eps·C, identical NaN patterns."""
    assert len(rolling.rolling_chunk_plan(t, 252)) > 1
    x64 = _rolling_input(torch.float64, cuda, t=t, n=n, seed=5)
    want = rolling.rolling_reduce_plain(x64, 252, 100, kind)
    got = rolling.rolling_reduce_cuda(x64, 252, 100, kind)
    np.testing.assert_array_equal(torch.isnan(got).cpu().numpy(),
                                  torch.isnan(want).cpu().numpy())
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-14, equal_nan=True)
    got32 = rolling.rolling_reduce_cuda(x64.float(), 252, 100, kind).double()
    np.testing.assert_array_equal(torch.isnan(got32).cpu().numpy(),
                                  torch.isnan(want).cpu().numpy())
    limit = 1e-4 * want.abs() + _rolling_limit(x64, kind, 252,
                                               torch.finfo(torch.float32).eps)
    fin = torch.isfinite(want)
    assert bool(((got32 - want).abs()[fin] <= limit[fin]).all())


def test_rolling_dispatch_launches_the_kernel(cuda):
    x = _rolling_input(torch.float64, cuda)
    before = rolling.rolling_reduce_cuda.launches
    out = rolling.rolling_sum(x[:, ::2], 12, 1)        # non-contiguous view
    assert rolling.rolling_reduce_cuda.launches == before + 1
    want = rolling.rolling_reduce_plain(x[:, ::2], 12, 1, "sum")
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-14, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rolling_mean_w120_on_figure_series(cuda, dtype):
    """Figure 1's roll: mean w=120 mp=60 on a (600, 15) series (3 subsets ×
    5 slopes) through the dispatch, counted under "mean/w=120,600x15"."""
    rng = np.random.default_rng(4)
    x = 0.01 * rng.standard_normal((600, 15))
    x[rng.random(x.shape) < 0.1] = np.nan
    xt = torch.tensor(x, dtype=dtype, device=cuda)
    before = rolling.rolling_reduce_cuda.launches_by_key.get("mean/w=120,600x15", 0)
    got = rolling.rolling_mean(xt, 120, 60)
    assert rolling.rolling_reduce_cuda.launches_by_key["mean/w=120,600x15"] == before + 1
    want = rolling.rolling_reduce_plain(xt, 120, 60, "mean")
    rtol, atol = (1e-10, 1e-16) if dtype == torch.float64 else (1e-4, 1e-9)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("t,n,infs", [
    (300, 257, False),
    (300, 257, True),
    (3000, 257, True),          # several chunks, the last ragged
    (1024, 2432, True),         # a short daily strip's width
    (4097, 33, True),           # 33 chunks of 128 rows, the last one row; one column in the last group
    (1, 257, True),             # one row: one chunk, no first pass
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_moments_kernel_matches_plain(cuda, dtype, t, n, infs):
    x = _rolling_input(dtype, cuda, t=t, n=n, seed=3, infs=infs)
    before = rolling.masked_cumulative_moments_cuda.launches
    got = rolling.masked_cumulative_moments(x)
    assert rolling.masked_cumulative_moments_cuda.launches == before + 1
    want = rolling.masked_cumulative_moments_plain(x)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * float(w.abs().max()))


def test_moments_kernel_is_bit_identical_run_to_run(cuda):
    """Fixed order of additions, no atomics: two launches give the same bits."""
    x = _rolling_input(torch.float32, cuda, t=3001, n=2437, seed=9, infs=True)
    assert len(rolling.moments_chunk_plan(3001)) > 1
    first = rolling.masked_cumulative_moments_cuda(x)
    second = rolling.masked_cumulative_moments_cuda(x)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_moments_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = _rolling_input(torch.float64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rolling.masked_cumulative_moments_cuda(x[:, ::2])
    with pytest.raises(TypeError):
        rolling.masked_cumulative_moments_cuda(x.half())
    with pytest.raises(ValueError):
        rolling.masked_cumulative_moments_cuda(x[None])


def test_rolling_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = _rolling_input(torch.float64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rolling.rolling_reduce_cuda(x[:, ::2], 12, 1, "sum")
    with pytest.raises(TypeError):
        rolling.rolling_reduce_cuda(x.half(), 12, 1, "sum")
    with pytest.raises(ValueError):
        rolling.rolling_reduce_cuda(x, 12, 1, "median")


def _gram_args(dtype, cuda, t=11, n=700, p=6, s=5, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < 0.1] = np.nan
    if n > 7 and p > 2:
        x[:, 7, 2] = np.nan
    y = rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.15] = np.nan
    universes = rng.random((2, t, n)) > 0.3
    universes[0, min(3, t - 1)] = False
    uidx = np.arange(s) % 2
    col_sel = rng.random((s, p)) > 0.4
    col_sel[0] = [True] + [False] * (p - 1)
    col_sel[-1] = True
    window = np.ones((s, t), bool)
    window[-1, :4] = False
    to = lambda a, dt=None: torch.tensor(a, device=cuda, dtype=dt)  # noqa: E731
    return (to(y, dtype), to(x, dtype), to(universes), to(uidx), to(col_sel),
            to(window))


@pytest.mark.parametrize("p,s", [(6, 5), (5, 3)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_gram_kernel_matches_plain(cuda, dtype, rtol, p, s):
    """P=5, S=3 is the figure grid's shape (5 variables × 3 universes)."""
    y, x, universes, uidx, col_sel, window = _gram_args(dtype, cuda, p=p, s=s)
    before = grams.gram_contract_cuda.launches
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window)
    assert grams.gram_contract_cuda.launches == before + 1
    want = grams.contract_spec_grams_plain(y, x, universes[uidx], col_sel, window,
                                           got.center)
    scale = torch.stack([want[0].abs().amax((-1, -2)), want[1].abs().amax(-1),
                         want[2].abs(), want[3].abs(), want[4].abs()]).amax(0)
    scale = scale.clamp_min(1.0)
    torch.testing.assert_close(got.n, want[2], rtol=0, atol=0)
    for g, w in zip(got[:5], want):
        s = scale.reshape(scale.shape + (1,) * (g.dim() - 2))
        assert bool(((g - w).abs() <= rtol * s).all())


@pytest.mark.parametrize("t,n,p,s", [
    (5, 1000, 6, 5),     # N not a multiple of any tile
    (4, 5, 6, 5),        # N below one tile
    (1, 700, 6, 5),      # one month
    (6, 700, 6, 1),      # one spec
    (3, 300, 32, 7),     # 7·34·35/2 = 4,165 entries: pairs over two blocks
    (3, 300, 0, 4),      # intercept and y only
])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_gram_kernel_edge_shapes(cuda, dtype, rtol, t, n, p, s):
    y, x, universes, uidx, col_sel, window = _gram_args(dtype, cuda, t=t, n=n,
                                                        p=max(p, 1), s=s)
    x, col_sel = x[..., :p].contiguous(), col_sel[:, :p].contiguous()
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window)
    want = grams.contract_spec_grams_plain(y, x, universes[uidx], col_sel, window,
                                           got.center)
    scale = torch.stack([want[0].abs().amax((-1, -2)), want[1].abs().amax(-1),
                         want[2].abs(), want[3].abs(), want[4].abs()]).amax(0)
    scale = scale.clamp_min(1.0)
    torch.testing.assert_close(got.n, want[2], rtol=0, atol=0)
    for g, w in zip(got[:5], want):
        sc = scale.reshape(scale.shape + (1,) * (g.dim() - 2))
        assert bool(((g - w).abs() <= rtol * sc).all())
    assert torch.equal(got.gram, got.gram.transpose(-1, -2))


def _held_to_plain(got, want, rtol, counts_exact=True):
    """Every statistic within ``rtol`` of its (spec, month) block's max-abs
    entry; counts exactly equal where the weights are 0/1."""
    scale = torch.stack([want[0].abs().amax((-1, -2)), want[1].abs().amax(-1),
                         want[2].abs(), want[3].abs(), want[4].abs()]).amax(0)
    scale = scale.clamp_min(1.0)
    if counts_exact:
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    for g, w in zip(got[:5], want):
        sc = scale.reshape(scale.shape + (1,) * (g.dim() - 2))
        assert bool(((g - w).abs() <= rtol * sc).all())


@pytest.mark.parametrize("p", [33, 40, 64, 100])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_gram_kernel_wide_unions_match_plain(cuda, dtype, rtol, p):
    """Past 32 columns (the columns as ⌈P/32⌉ words a spec): float64 and
    float32, with and without row weights, against the plain version; one
    launch takes the spec batch in both; counts exact under 0/1 weights,
    symmetric blocks."""
    y, x, universes, uidx, col_sel, window = _gram_args(dtype, cuda, t=5, n=900, p=p, s=5)
    x[:, 11, p - 1] = float("nan")                    # a non-finite column of the last word
    col_sel[1] = False
    col_sel[1, p - 1] = True
    before = grams.gram_contract_cuda.launches
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window)
    assert grams.gram_contract_cuda.launches == before + -(-5 // grams.gram_spec_chunk(
        p, dtype=dtype))
    want = grams.contract_spec_grams_plain(y, x, universes[uidx], col_sel, window, got.center)
    _held_to_plain(got, want, rtol)
    assert torch.equal(got.gram, got.gram.transpose(-1, -2))
    rw = torch.tensor(np.random.default_rng(p).random(y.shape) * 2, dtype=dtype, device=cuda)
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window, row_weights=rw)
    want = grams.contract_spec_grams_plain(y, x, universes[uidx], col_sel, window,
                                           got.center, row_weights=rw)
    _held_to_plain(got, want, rtol, counts_exact=False)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_gram_kernel_row_weights_match_plain(cuda, dtype, rtol):
    y, x, universes, uidx, col_sel, window = _gram_args(dtype, cuda, p=14, s=9)
    rng = np.random.default_rng(5)
    rw = torch.tensor(rng.random(y.shape) * 2, dtype=dtype, device=cuda)
    rw[:, ::7] = 0.0                                   # rows outside the coreset
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window,
                                    row_weights=rw)
    want = grams.contract_spec_grams_plain(y, x, universes[uidx], col_sel, window,
                                           got.center, row_weights=rw)
    _held_to_plain(got, want, rtol, counts_exact=False)
    # 0/1 weights: the counts are exact again
    ones = (rw > 0.5).to(dtype)
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window,
                                    row_weights=ones)
    want = grams.contract_spec_grams_plain(y, x, universes[uidx], col_sel, window,
                                           got.center, row_weights=ones)
    _held_to_plain(got, want, rtol)


@pytest.mark.parametrize("weighted", [False, True])
def test_gram_kernel_bf16_matches_plain(cuda, weighted):
    y, x, universes, uidx, col_sel, window = _gram_args(torch.float32, cuda, p=14, s=9)
    rw = None
    if weighted:
        rng = np.random.default_rng(6)
        rw = torch.tensor(rng.random(y.shape) * 2, dtype=torch.float32, device=cuda)
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window,
                                    row_weights=rw, precision="bf16")
    assert got.gram.dtype == torch.float32
    bf = torch.bfloat16
    want = grams.contract_spec_grams_plain(
        y.to(bf), x.to(bf), universes[uidx], col_sel, window, got.center.to(bf),
        row_weights=None if rw is None else rw.to(bf))
    _held_to_plain(got, want, 1e-5, counts_exact=not weighted)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_gram_kernel_splits_spec_batches(cuda, dtype, rtol):
    """S = 123 at P = 14 is three launches of at most 60 specs in float32
    and one in float64; repeated calls give the same bits."""
    assert grams.gram_spec_chunk(14) == 60
    y, x, universes, uidx, col_sel, window = _gram_args(dtype, cuda, t=5, n=400,
                                                        p=14, s=123)
    before = grams.gram_contract_cuda.launches
    got = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window)
    assert grams.gram_contract_cuda.launches == before + (1 if dtype == torch.float64 else 3)
    want = grams.contract_spec_grams_plain(y, x, universes[uidx], col_sel, window,
                                           got.center)
    _held_to_plain(got, want, rtol)
    again = grams.contract_spec_grams(y, x, universes, uidx, col_sel, window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gram_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    y, x, universes, uidx, col_sel, window = _gram_args(torch.float64, cuda)
    valid = universes[uidx].to(torch.uint8)
    center = grams.shared_center(x)
    with pytest.raises(TypeError):
        grams.gram_contract_cuda(y.float(), x, valid, col_sel, center)
    with pytest.raises(TypeError):
        grams.gram_contract_cuda(y, x, universes[uidx], col_sel, center)
    with pytest.raises(TypeError):
        grams.gram_contract_cuda(y.to(torch.bfloat16), x.to(torch.bfloat16), valid,
                                 col_sel, center)
    with pytest.raises(TypeError):
        grams.gram_contract_cuda(y, x, valid, col_sel, center, row_weights=y.float())
    with pytest.raises(ValueError, match="contiguous"):
        grams.gram_contract_cuda(y, x.transpose(0, 1), valid, col_sel, center)


def _bf16_gram_case(cuda, t, n, p, s, weights, seed=7):
    """bfloat16 operands for the tensor-core kernel: NaNs, an all-NaN column
    (every firm), row weights None, 0/1 or real-valued (coreset-like, most
    rows 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p)) * 3.0
    x[rng.random(x.shape) < 0.1] = np.nan
    if p >= 2:
        x[:, :, p // 2] = np.nan
    y = rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.15] = np.nan
    universes = rng.random((3, t, n)) > np.array([0.1, 0.4, 0.7])[:, None, None]
    uidx = np.arange(s) % 3
    col_sel = rng.random((s, p)) > 0.4
    col_sel[0] = False
    col_sel[0, 0] = True
    col_sel[-1] = True
    rw = None
    if weights is not None:
        u = rng.random((t, n))
        w = np.ones_like(u) if weights == "binary" else 0.5 + 4.0 * u
        rw = torch.tensor(np.where(u < 0.3, w, 0.0), device=cuda, dtype=torch.bfloat16)
    bf = torch.bfloat16
    xt = torch.tensor(x, device=cuda, dtype=bf)
    center = grams.shared_center(torch.tensor(x, device=cuda, dtype=torch.float32)).to(bf)
    uni = torch.tensor(universes[uidx], device=cuda)
    return (torch.tensor(y, device=cuda, dtype=bf), xt, uni,
            uni.to(torch.uint8).contiguous(), torch.tensor(col_sel, device=cuda), center, rw)


@pytest.mark.parametrize("weights", [None, "binary", "real"])
@pytest.mark.parametrize("n", [400, 3000])
@pytest.mark.parametrize("s", [1, 9, 61])
@pytest.mark.parametrize("p", [1, 5, 14, 15, 30, 32, 33, 40, 64, 100])
def test_gram_bf16_tensor_core_kernel(cuda, p, s, n, weights):
    """The tensor-core bf16 kernel against the float64 sums of the same bf16
    terms (1e-5 of each block's max-abs entry) and against the float32 plain
    version (1e-5 plus that version's own error against the float64 sums);
    counts exact for 0/1 weights, a repeated call bit-identical, each block
    symmetric. N = 400 and 3,000 leave ragged tiles; S = 61 takes two
    launches at P = 14 (more at P >= 15), and one past 32 columns, where
    one launch takes any spec batch."""
    y, x, uni, valid, col_sel, center, rw = _bf16_gram_case(cuda, 4, n, p, s, weights)
    window = torch.ones((s, 4), dtype=torch.bool, device=cuda)
    before = grams.gram_contract_cuda.launches
    out = grams.gram_contract_cuda(y, x, valid, col_sel, center, rw)
    launches = grams.gram_contract_cuda.launches - before
    assert launches == -(-s // grams.gram_spec_chunk(p, dtype=torch.bfloat16))
    assert launches == 1 or p <= 32
    assert out.dtype == torch.float32
    got = grams.split_stats(out, p)
    want = grams.contract_spec_grams_plain(y, x, uni, col_sel, window, center,
                                           row_weights=rw)
    exact = grams.contract_spec_grams_plain(
        y.double(), (x - center[:, None, :]).double(), uni, col_sel, window,
        torch.zeros(center.shape, dtype=torch.float64, device=cuda),
        row_weights=None if rw is None else rw.double())

    def worst(a, b):
        scale = torch.stack([b[0].abs().amax((-1, -2)), b[1].abs().amax(-1), b[2].abs(),
                             b[3].abs(), b[4].abs()]).amax(0).clamp_min(1.0)
        return max(float(torch.nan_to_num(
            (g.double() - w.double()).abs() / scale.reshape(scale.shape + (1,) * (g.dim() - 2)),
            nan=float("inf")).max()) for g, w in zip(a, b))

    plain_err = worst(want, exact)
    assert worst(got, exact) <= 1e-5
    assert worst(got, want) <= 1e-5 + plain_err
    if weights != "real":
        assert torch.equal(got[2], want[2])
    assert torch.equal(out, out.transpose(-1, -2))
    assert torch.equal(out, grams.gram_contract_cuda(y, x, valid, col_sel, center, rw))


def _gram_case(cuda, dtype, t, n, p, s, weights, seed=11):
    """Operands of ``dtype`` for the float64 (DMMA) and wide float32
    kernels: NaNs and infinities, an all-NaN column (every firm) from
    P = 4, a non-finite entry in the last column, specs selecting the first
    column only, the last only and every column, row weights None, 0/1 or
    real-valued (coreset-like, most rows 0)."""
    rng = np.random.default_rng(seed + 7 * p + s)
    x = rng.standard_normal((t, n, p)) * 3.0
    x[rng.random(x.shape) < 0.05] = np.nan
    x[rng.random(x.shape) < 0.005] = np.inf
    if p >= 4:
        x[:, :, p // 2] = np.nan
    x[:, 11, p - 1] = -np.inf
    y = rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.1] = np.nan
    universes = rng.random((3, t, n)) > np.array([0.1, 0.4, 0.7])[:, None, None]
    uidx = np.arange(s) % 3
    col_sel = rng.random((s, p)) > 0.4
    col_sel[0] = False
    col_sel[0, 0] = True
    if s > 2:
        col_sel[1] = False
        col_sel[1, p - 1] = True
    col_sel[-1] = True
    rw = None
    if weights is not None:
        u = rng.random((t, n))
        w = np.ones_like(u) if weights == "binary" else 0.5 + 4.0 * u
        rw = torch.tensor(np.where(u < 0.3, w, 0.0), device=cuda, dtype=dtype)
    xt = torch.tensor(x, device=cuda, dtype=dtype)
    uni = torch.tensor(universes[uidx], device=cuda)
    return (torch.tensor(y, device=cuda, dtype=dtype), xt, uni,
            uni.to(torch.uint8).contiguous(), torch.tensor(col_sel, device=cuda),
            grams.shared_center(xt), rw)


@pytest.mark.parametrize("weights", [None, "binary", "real"])
@pytest.mark.parametrize("s", [1, 9, 61])
@pytest.mark.parametrize("p", [1, 5, 14, 15, 30, 32, 33, 40, 64, 100])
def test_gram_f64_tensor_core_kernel(cuda, p, s, weights):
    """The float64 kernel (DMMA) against its plain version at 1e-12 of each
    block's max-abs entry: counts exact under 0/1 weights, one launch
    whatever the spec batch, a repeated call bit-identical, each block
    symmetric. N = 1,001 leaves a ragged tile and a ragged 8-firm step."""
    t, n = 3, 1001
    y, x, uni, valid, col_sel, center, rw = _gram_case(cuda, torch.float64, t, n, p, s,
                                                       weights)
    window = torch.ones((s, t), dtype=torch.bool, device=cuda)
    assert grams.gram_spec_chunk(p, dtype=torch.float64) >= s
    before = grams.gram_contract_cuda.launches
    out = grams.gram_contract_cuda(y, x, valid, col_sel, center, rw)
    assert grams.gram_contract_cuda.launches == before + 1
    assert out.dtype == torch.float64
    got = grams.split_stats(out, p)
    want = grams.contract_spec_grams_plain(y, x, uni, col_sel, window, center,
                                           row_weights=rw)
    _held_to_plain(got, want, 1e-12, counts_exact=weights != "real")
    assert torch.equal(out, out.transpose(-1, -2))
    assert torch.equal(out, grams.gram_contract_cuda(y, x, valid, col_sel, center, rw))


@pytest.mark.parametrize("weights", [None, "binary", "real"])
@pytest.mark.parametrize("s", [1, 9, 61])
@pytest.mark.parametrize("p", [33, 40, 63, 64, 65, 100, 160])
def test_gram_f32_wide_kernel(cuda, p, s, weights):
    """The float32 kernel past 32 columns (``gram_f32_wide_kernel``) against
    its plain version at 1e-5 of each block's max-abs entry: counts exact
    under 0/1 weights, one launch whatever the spec batch, a repeated call
    bit-identical, each block symmetric. N = 1,001 leaves a ragged tile;
    the last column (in the last selection word) holds a non-finite entry.
    The widest unions, one launch and column panels on each side of its
    reach, are ``test_gram_kernel_on_each_side_of_one_launch``'s."""
    t, n = 3, 1001
    y, x, uni, valid, col_sel, center, rw = _gram_case(cuda, torch.float32, t, n, p, s,
                                                       weights)
    window = torch.ones((s, t), dtype=torch.bool, device=cuda)
    assert grams.gram_spec_chunk(p, dtype=torch.float32) >= s
    before = grams.gram_contract_cuda.launches
    out = grams.gram_contract_cuda(y, x, valid, col_sel, center, rw)
    assert grams.gram_contract_cuda.launches == before + 1
    assert out.dtype == torch.float32
    got = grams.split_stats(out, p)
    want = grams.contract_spec_grams_plain(y, x, uni, col_sel, window, center,
                                           row_weights=rw)
    _held_to_plain(got, want, 1e-5, counts_exact=weights != "real")
    assert torch.equal(out, out.transpose(-1, -2))
    assert torch.equal(out, grams.gram_contract_cuda(y, x, valid, col_sel, center, rw))


# each side of the reach one launch had before column panels, at 9 specs
# (1 spec reaches 850 float32 columns, 849 with row weights), and wider
# unions: (dtype, P, row weights: None, "binary" (0/1) or "real")
_UNWEIGHTED, _WEIGHTED, _ALL = (None,), ("binary", "real"), (None, "binary", "real")
PANEL_CASES = [(dtype, p, kind) for dtype, p, kinds in (
    (torch.float64, 423, _WEIGHTED), (torch.float64, 424, _ALL), (torch.float64, 425, _ALL),
    (torch.float32, 847, _WEIGHTED), (torch.float32, 848, _ALL), (torch.float32, 849, _ALL),
    (torch.bfloat16, 622, _WEIGHTED), (torch.bfloat16, 623, _WEIGHTED),
    (torch.bfloat16, 1367, _UNWEIGHTED), (torch.bfloat16, 1368, _UNWEIGHTED),
    *((dtype, p, _ALL) for p in (920, 2000)
      for dtype in (torch.float64, torch.float32, torch.bfloat16))) for kind in kinds]


@pytest.mark.parametrize("s", [1, 9])
@pytest.mark.parametrize("dtype, p, kind", PANEL_CASES)
def test_gram_kernel_on_each_side_of_one_launch(cuda, dtype, p, kind, s):
    """Unions up to and past the widest one launch of the wide kernels takes
    (424 float64 columns, 848 float32, 1,367 bfloat16; fewer with row
    weights): every operand type the pre-pass and one launch of the
    tile-pair kernel (``gram_tile_plan``) on each side. Held to the
    plain version at 1e-12 of each block's max in float64 and 1e-5 in
    float32, bfloat16 at 1e-5 of the float64 sums of the same terms (the
    plain version within 1e-5 plus its own error of them); counts exact
    under 0/1 weights, each block symmetric, a repeated call bit-identical.
    T = 2, N = 1,001: a ragged tile."""
    t, n = 2, 1001
    src = torch.float32 if dtype == torch.bfloat16 else dtype
    y, x, uni, valid, col_sel, center, rw = _gram_case(cuda, src, t, n, p, s, kind)
    if dtype == torch.bfloat16:
        y, x, center = (a.to(dtype) for a in (y, x, center))
        rw = None if rw is None else rw.to(dtype)
    assert grams.gram_launch_fits(p, dtype, s, rw is not None)
    tiles = grams.gram_tile_plan(p, dtype, s)
    assert tiles is not None
    window = torch.ones((s, t), dtype=torch.bool, device=cuda)
    before = grams.gram_contract_cuda.launches, grams.gram_fold_cuda.launches
    out = grams.gram_contract_cuda(y, x, valid, col_sel, center, rw)
    launches = (grams.gram_contract_cuda.launches - before[0],
                grams.gram_fold_cuda.launches - before[1])
    assert launches == (grams.gram_launch_count(p, s, dtype), 1) == (1, 1)
    got = grams.split_stats(out, p)
    want = grams.contract_spec_grams_plain(y, x, uni, col_sel, window, center,
                                           row_weights=rw)
    if dtype == torch.bfloat16:
        exact = grams.contract_spec_grams_plain(
            y.double(), (x - center[:, None, :]).double(), uni, col_sel, window,
            torch.zeros(center.shape, dtype=torch.float64, device=cuda),
            row_weights=None if rw is None else rw.double())
        plain_err = _worst_to_block(want, exact)
        assert _worst_to_block(got, exact) <= 1e-5
        assert _worst_to_block(got, want) <= 1e-5 + plain_err
        if kind != "real":
            assert torch.equal(got[2], want[2])
    else:
        _held_to_plain(got, want, 1e-12 if dtype == torch.float64 else 1e-5,
                       counts_exact=kind != "real")
    assert torch.equal(out, out.transpose(-1, -2))
    assert torch.equal(out, grams.gram_contract_cuda(y, x, valid, col_sel, center, rw))


# each side of the crossover, the old reach of the one-launch float64
# kernel, the 920-column union, unaligned rows (921 and 1,001 columns: no
# 16-byte row stride in either type) and a wide union; float32 also each
# side of its one-launch kernel's reach (848 columns)
TILE_WIDTHS = sorted({w for dtype, start in grams.GRAM_TILE_FROM.items()
                      for w in (start - 1, start)} | {425, 920, 921, 1001, 2000})
F32_FROM = grams.GRAM_TILE_FROM[torch.float32]
F32_TILE_WIDTHS = (F32_FROM - 1, F32_FROM, 425, 848, 849, 920, 921, 1001, 2000)
# float32's one-spec groups (S = 1, and the last group of S = 7: 3, 3, 1)
# run in a child process under a time limit (test_gram_f32_tile_one_spec_groups)
TILE_CASES = ([(dtype, p, s) for dtype in (torch.float64, torch.bfloat16) for p in TILE_WIDTHS
               for s in (1, 3, 9)]
              + [(dtype, p, 61) for dtype in (torch.float64, torch.bfloat16)
                 for p in (grams.GRAM_TILE_FROM[dtype], 425)]
              + [(torch.float32, p, s) for p in F32_TILE_WIDTHS for s in (3, 4, 9)]
              + [(torch.float32, p, 61) for p in (F32_FROM, 920)])


def check_tile_case(cuda, dtype, p, s, weights):
    """One tile-pair case against the plain version: float64 at 1e-12 of
    each block's max-abs entry, float32 at 1e-5, bfloat16 at 1e-5 of the
    float64 sums of the same bf16 terms (the float32 plain version within
    1e-5 plus its own error of them); counts exact under 0/1 weights, each
    block symmetric, a repeated call bit-identical; the pre-pass and one
    launch from the crossover, one launch of the one-launch kernel below
    it. T = 3, N = 1,001: a ragged chunk of firms and a ragged MMA step."""
    t, n = 3, 1001
    src = torch.float32 if dtype == torch.bfloat16 else dtype
    y, x, uni, valid, col_sel, center, rw = _gram_case(cuda, src, t, n, p, s, weights)
    if dtype == torch.bfloat16:
        y, x, center = (a.to(dtype) for a in (y, x, center))
        rw = None if rw is None else rw.to(dtype)
    tiles = grams.gram_tile_plan(p, dtype, s)
    assert (tiles is not None) == (p >= grams.GRAM_TILE_FROM[dtype])
    window = torch.ones((s, t), dtype=torch.bool, device=cuda)
    before = grams.gram_contract_cuda.launches, grams.gram_fold_cuda.launches
    out = grams.gram_contract_cuda(y, x, valid, col_sel, center, rw)
    launches = (grams.gram_contract_cuda.launches - before[0],
                grams.gram_fold_cuda.launches - before[1])
    assert launches == (1, 0 if tiles is None else 1)
    got = grams.split_stats(out, p)
    want = grams.contract_spec_grams_plain(y, x, uni, col_sel, window, center,
                                           row_weights=rw)
    if dtype == torch.bfloat16:
        assert out.dtype == torch.float32
        exact = grams.contract_spec_grams_plain(
            y.double(), (x - center[:, None, :]).double(), uni, col_sel, window,
            torch.zeros(center.shape, dtype=torch.float64, device=cuda),
            row_weights=None if rw is None else rw.double())
        plain_err = _worst_to_block(want, exact)
        assert _worst_to_block(got, exact) <= 1e-5
        assert _worst_to_block(got, want) <= 1e-5 + plain_err
        if weights != "real":
            assert torch.equal(got[2], want[2])
    else:
        assert out.dtype == dtype
        _held_to_plain(got, want, 1e-12 if dtype == torch.float64 else 1e-5,
                       counts_exact=weights != "real")
    assert torch.equal(out, out.transpose(-1, -2))
    assert torch.equal(out, grams.gram_contract_cuda(y, x, valid, col_sel, center, rw))


@pytest.mark.parametrize("weights", [None, "binary", "real"])
@pytest.mark.parametrize("dtype, p, s", TILE_CASES)
def test_gram_tile_pair_kernel(cuda, dtype, p, s, weights):
    """The tile-pair kernel (``gram_f32_tiles_kernel``,
    ``gram_dmma_tiles_kernel``, ``gram_tc_tiles_kernel``) as
    ``check_tile_case`` holds it."""
    check_tile_case(cuda, dtype, p, s, weights)


F32_ONE_SPEC_CHILD = """
import sys
import torch
sys.path.insert(0, {tests!r})
import test_torch_cuda_kernels as k
for p in {widths!r}:
    for s in (1, 7):
        for weights in (None, "binary", "real"):
            k.check_tile_case(torch.device("cuda"), torch.float32, p, s, weights)
            print("finished", p, s, weights, flush=True)
"""


def test_gram_f32_tile_one_spec_groups(cuda):
    """float32's one-spec groups on the tile-pair kernel (S = 1 on the
    one-spec instance; S = 7, whose last group holds one spec, on the
    three-spec one), held as ``check_tile_case`` holds them, in a child
    process under a time limit: a block that never finishes fails this test
    instead of stalling the run."""
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    widths = (F32_FROM, 920, 921, 2000)
    code = F32_ONE_SPEC_CHILD.format(tests=str(tests), widths=widths)
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=tests.parent, timeout=900,
                              capture_output=True, text=True)
    except subprocess.TimeoutExpired as exc:
        pytest.fail(f"float32 one-spec tile cases did not finish in 900 s: {exc.stdout!r}")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.count("finished") == len(widths) * 2 * 3


def _worst_to_block(a, b) -> float:
    """The largest difference of two sets of split stats, each relative to
    its (spec, month) block's max-abs entry in ``b`` (a NaN: infinite)."""
    scale = torch.stack([b[0].abs().amax((-1, -2)), b[1].abs().amax(-1), b[2].abs(),
                         b[3].abs(), b[4].abs()]).amax(0).clamp_min(1.0)
    return max(float(torch.nan_to_num(
        (g.double() - w.double()).abs() / scale.reshape(scale.shape + (1,) * (g.dim() - 2)),
        nan=float("inf")).max()) for g, w in zip(a, b))


def test_gram_fold_kernel_matches_plain(cuda):
    """The panel route's pre-pass against its plain version, bit for bit:
    float64, float32 and bfloat16 operands, 40 specs (two passes over a
    row), 2,000 columns."""
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        y, x, uni, valid, col_sel, _, _ = _gram_case(cuda, torch.float64, 2, 777, 2000, 40,
                                                      None)
        y, x = y.to(dtype), x.to(dtype)
        before = grams.gram_fold_cuda.launches
        got = grams.gram_fold_cuda(y, x, valid, col_sel)
        assert grams.gram_fold_cuda.launches == before + 1
        assert torch.equal(got, grams.gram_fold_plain(y, x, valid, col_sel))
