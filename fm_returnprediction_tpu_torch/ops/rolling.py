"""Masked trailing-window reductions along the time axis.

pandas ``rolling(window, min_periods)`` semantics on axis 0: the window
covers the trailing ``window`` ROWS (truncated at the series start), NaN
entries occupy window positions but are excluded from the reduction, and
the result is NaN until ``min_periods`` non-NaN entries are present.

``rolling_sum``, ``rolling_mean`` and ``rolling_std`` take one of two
versions, chosen by where the tensor lies:

- a CUDA tensor goes to the hand-written kernel (``csrc/rolling.cu``,
  wrapper ``rolling_reduce_cuda``): one read of ``x``, one write of the
  finished reduction, the time axis cut into chunks of
  ``rolling_chunk_rows(window)`` rows that each warm up from one window
  before their first row (``rolling_chunk_plan``);
- a CPU tensor takes the plain version, the cumulative-sum difference plus
  the ``finalize_*`` functions below (``rolling_reduce_plain``).

There is no fallback between the two. ``rolling_prod`` is plain PyTorch on
either device.

``masked_cumulative_moments`` (the inclusive masked Σx, Σx², count) is
dispatched the same way: ``masked_cumulative_moments_cuda`` launches the
kernel of the same source, ``masked_cumulative_moments_plain`` is three
``torch.cumsum`` passes.
"""

from __future__ import annotations

import ctypes

import torch

from fm_returnprediction_tpu_torch.cuda_build import check_status, kernel_function

__all__ = [
    "windowed_sum",
    "windowed_count",
    "finalize_sum",
    "finalize_mean",
    "finalize_std",
    "rolling_reduce_plain",
    "rolling_chunk_rows",
    "rolling_chunk_plan",
    "rolling_reduce_cuda",
    "rolling_sum",
    "rolling_mean",
    "rolling_std",
    "rolling_prod",
    "masked_cumulative_moments_plain",
    "masked_cumulative_moments_cuda",
    "masked_cumulative_moments",
]

_KINDS = {"sum": 0, "mean": 1, "std": 2}
_MIN_CHUNK_ROWS = 512
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def windowed_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Exact trailing-window sum (window truncated at the start) of a
    NaN-free tensor via cumulative-sum difference."""
    cs = torch.cumsum(x, dim=0)
    zeros = torch.zeros((window,) + tuple(x.shape[1:]), dtype=cs.dtype,
                        device=cs.device)
    shifted = torch.cat([zeros, cs[: max(x.shape[0] - window, 0)]], dim=0)
    return cs - shifted[: x.shape[0]]


def windowed_count(finite: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing-window count of True entries."""
    return windowed_sum(finite.to(torch.int64), window)


def _gate(value, count, min_periods: int):
    return torch.where(count >= min_periods, value,
                       torch.full_like(value, float("nan")))


def finalize_sum(s1, count, min_periods: int) -> torch.Tensor:
    """Windowed sum + count → gated rolling sum."""
    return _gate(s1, count, min_periods)


def finalize_mean(s1, count, min_periods: int) -> torch.Tensor:
    """Windowed sum + count → gated rolling mean."""
    mean = s1 / torch.clamp_min(count, 1).to(s1.dtype)
    return _gate(mean, count, min_periods)


def finalize_std(s1, s2, count, min_periods: int) -> torch.Tensor:
    """Windowed moments → pandas rolling std (ddof=1) with gating: NaN below
    two finite entries, variance clamped at 0."""
    cf = count.to(s1.dtype)
    denom = torch.clamp_min(cf - 1.0, 1.0)
    var = torch.clamp_min(s2 - s1 * s1 / torch.clamp_min(cf, 1.0), 0.0) / denom
    out = torch.sqrt(var)
    out = torch.where(count >= 2, out, torch.full_like(out, float("nan")))
    return _gate(out, count, min_periods)


def rolling_reduce_plain(x: torch.Tensor, window: int, min_periods: int,
                         kind: str) -> torch.Tensor:
    """The plain PyTorch version of the rolling kernel, on any device:
    masked cumulative-sum differences, then the shared finalization."""
    finite = torch.isfinite(x)
    xz = torch.where(finite, x, torch.zeros_like(x))
    count = windowed_count(finite, window)
    s1 = windowed_sum(xz, window)
    if kind == "sum":
        return finalize_sum(s1, count, min_periods)
    if kind == "mean":
        return finalize_mean(s1, count, min_periods)
    if kind == "std":
        return finalize_std(s1, windowed_sum(xz * xz, window), count,
                            min_periods)
    raise ValueError(f"kind must be one of {tuple(_KINDS)}, got {kind!r}")


def _check_kernel_input(x: torch.Tensor, what: str) -> None:
    """Raise on a tensor the kernels of ``csrc/rolling.cu`` do not take."""
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32/float64, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what} takes a (T, N) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")


def rolling_chunk_rows(window: int) -> int:
    """Rows of the time axis one block of the rolling kernel writes: at
    least two windows, so a chunk's warm-up (at most one window) is at most
    half its walk, and at least 512 rows. It depends on the window alone,
    never on the card, so a result does not depend on the SM count."""
    return max(2 * int(window), _MIN_CHUNK_ROWS)


def rolling_chunk_plan(t_len: int, window: int):
    """The rolling kernel's chunks as ``(anchor, start, stop)`` triples: the
    block for rows ``[start, stop)`` starts both running triples from zero at
    ``anchor = max(start - window, 0)`` and writes from ``start`` on."""
    chunk = rolling_chunk_rows(window)
    return [(max(start - window, 0), start, min(start + chunk, t_len))
            for start in range(0, t_len, chunk)]


def rolling_reduce_cuda(x: torch.Tensor, window: int, min_periods: int,
                        kind: str) -> torch.Tensor:
    """Launch the rolling kernel on a contiguous (T, N) float32/float64
    CUDA tensor. Raises on anything the kernel does not take."""
    _check_kernel_input(x, "rolling kernel")
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {tuple(_KINDS)}, got {kind!r}")
    if window < 1 or min_periods < 0:
        raise ValueError(f"bad window={window} / min_periods={min_periods}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = kernel_function("rolling", "rolling_reduce", [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ])
    chunk = rolling_chunk_rows(window)
    with torch.cuda.device(x.device):
        status = fn(_DTYPE_CODES[x.dtype], _KINDS[kind], x.data_ptr(),
                    out.data_ptr(), x.shape[0], x.shape[1], int(window),
                    int(min_periods), chunk,
                    torch.cuda.current_stream().cuda_stream)
    check_status("rolling", status)
    rolling_reduce_cuda.launches += 1
    key = f"{kind}/w={window},{x.shape[0]}x{x.shape[1]}"
    by_key = rolling_reduce_cuda.launches_by_key
    by_key[key] = by_key.get(key, 0) + 1
    return out


# launch counters: the total, and per "kind/w=window,TxN"
rolling_reduce_cuda.launches = 0
rolling_reduce_cuda.launches_by_key = {}


def _rolling(x: torch.Tensor, window: int, min_periods: int, kind: str):
    if not x.is_cuda:
        return rolling_reduce_plain(x, window, min_periods, kind)
    # columns are independent: any trailing shape flattens to (T, N)
    flat = x.reshape(x.shape[0], -1).contiguous()
    return rolling_reduce_cuda(flat, window, min_periods, kind).reshape(x.shape)


def rolling_sum(x: torch.Tensor, window: int, min_periods: int) -> torch.Tensor:
    """pandas ``.rolling(window, min_periods).sum()`` on axis 0."""
    return _rolling(x, window, min_periods, "sum")


def rolling_mean(x: torch.Tensor, window: int, min_periods: int) -> torch.Tensor:
    """pandas ``.rolling(window, min_periods).mean()`` on axis 0."""
    return _rolling(x, window, min_periods, "mean")


def rolling_std(x: torch.Tensor, window: int, min_periods: int) -> torch.Tensor:
    """pandas ``.rolling(window, min_periods).std()`` (ddof=1) on axis 0."""
    return _rolling(x, window, min_periods, "std")


def rolling_prod(x: torch.Tensor, window: int, min_periods: int) -> torch.Tensor:
    """pandas ``.rolling(window, min_periods).apply(np.prod)`` on axis 0.

    Exact windowed product over a ones-padded sliding view (no cumulative
    division, so zeros and sign changes are exact). NaNs PROPAGATE through
    the product, as ``np.prod`` of a window holding a NaN is NaN; the result
    is NaN until ``min_periods`` finite entries are present."""
    pad = torch.ones((window - 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                     device=x.device)
    prod = torch.cat([pad, x], dim=0).unfold(0, window, 1).prod(dim=-1)
    return _gate(prod, windowed_count(torch.isfinite(x), window), min_periods)


def masked_cumulative_moments_plain(x: torch.Tensor):
    """The plain PyTorch version of the moments kernel, on any device:
    inclusive cumulative Σx, Σx² and count along axis 0, non-finite
    entries contributing zero; all three in x's dtype."""
    finite = torch.isfinite(x)
    xz = torch.where(finite, x, torch.zeros_like(x))
    return (torch.cumsum(xz, dim=0), torch.cumsum(xz * xz, dim=0),
            torch.cumsum(finite.to(x.dtype), dim=0))


def masked_cumulative_moments_cuda(x: torch.Tensor):
    """Launch the moments kernel on a contiguous (T, N) float32/float64
    CUDA tensor; returns ``(csum, csumsq, ccnt)``. Raises on anything the
    kernel does not take."""
    _check_kernel_input(x, "moments kernel")
    csum, csumsq, ccnt = (torch.empty_like(x) for _ in range(3))
    if x.numel() == 0:
        return csum, csumsq, ccnt
    fn = kernel_function("rolling", "masked_cumulative_moments", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        status = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), csum.data_ptr(),
                    csumsq.data_ptr(), ccnt.data_ptr(), x.shape[0], x.shape[1],
                    torch.cuda.current_stream().cuda_stream)
    check_status("rolling", status)
    masked_cumulative_moments_cuda.launches += 1
    return csum, csumsq, ccnt


masked_cumulative_moments_cuda.launches = 0


def masked_cumulative_moments(x: torch.Tensor):
    """Inclusive cumulative (Σx, Σx², count) over axis 0 of a (T, N)
    tensor, NaN-masked: the kernel for a CUDA tensor, the plain version for
    a CPU one. Returns three (T, N) tensors in x's dtype."""
    if not x.is_cuda:
        return masked_cumulative_moments_plain(x)
    return masked_cumulative_moments_cuda(x.contiguous())
