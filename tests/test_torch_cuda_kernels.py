"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need a CUDA device and the CUDA toolkit (the kernels are built
on first use); without a device they skip. On a machine with one GPU:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: float64 at rtol 1e-10 for the rolling family (both sides
difference two cumulative sums, so a small window std under a large running
sum loses digits to cancellation) and 1e-12 of each (spec, month) block's
max-abs entry for the Gram contraction; the cumulative moments at 1e-12
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


def test_gram_wrapper_refuses_too_many_entries(cuda):
    y, x, universes, uidx, col_sel, window = _gram_args(torch.float32, cuda, t=2,
                                                        n=50, p=32, s=14)
    valid = universes[uidx].to(torch.uint8)
    with pytest.raises(ValueError, match="8192"):   # 14·34·35/2 = 8,330
        grams.gram_contract_cuda(y, x, valid, col_sel, grams.shared_center(x))


def test_gram_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    y, x, universes, uidx, col_sel, window = _gram_args(torch.float64, cuda)
    valid = universes[uidx].to(torch.uint8)
    center = grams.shared_center(x)
    with pytest.raises(TypeError):
        grams.gram_contract_cuda(y.float(), x, valid, col_sel, center)
    with pytest.raises(TypeError):
        grams.gram_contract_cuda(y, x, universes[uidx], col_sel, center)
    with pytest.raises(ValueError, match="contiguous"):
        grams.gram_contract_cuda(y, x.transpose(0, 1), valid, col_sel, center)
