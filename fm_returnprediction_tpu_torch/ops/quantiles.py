"""Masked cross-sectional quantiles and winsorization.

Two consumers in the pipeline: the NYSE size breakpoints (monthly 20th/50th
percentiles of NYSE market equity, pandas ``.quantile`` linear
interpolation) and the per-month winsorization at [1%, 99%] per variable,
skipping months with fewer than 5 valid observations (``np.percentile``,
also linear). Both interpolate linearly at rank ``q · (n_valid − 1)`` of a
month's valid entries.
"""

from __future__ import annotations

import math

import torch

__all__ = ["masked_quantile", "winsorize_cs", "winsorize_cs_batched"]


def masked_quantile(values: torch.Tensor, valid: torch.Tensor, q) -> torch.Tensor:
    """Linear-interpolated quantile(s) of the valid entries of each row.

    values, valid: (T, N); quantiles along the last axis. ``q`` is a float
    or a sequence of Q floats. Returns (T,) for a float, else (T, Q); rows
    with no valid entries give NaN. Matches ``np.percentile`` /
    ``pd.Series.quantile`` 'linear' interpolation exactly.
    """
    scalar = isinstance(q, (int, float))
    q_arr = torch.as_tensor([q] if scalar else list(q), dtype=values.dtype,
                            device=values.device)
    ok = valid & torch.isfinite(values)
    data = torch.where(ok, values, torch.full_like(values, float("inf")))
    data = torch.sort(data, dim=-1).values
    n = ok.sum(dim=-1)
    nm1 = torch.clamp_min(n - 1, 0)

    rank = q_arr[None, :] * nm1[:, None].to(values.dtype)
    lo = torch.floor(rank).to(torch.int64)
    hi = torch.minimum(lo + 1, nm1[:, None])
    frac = rank - lo.to(values.dtype)
    out = (torch.gather(data, -1, lo) * (1.0 - frac)
           + torch.gather(data, -1, hi) * frac)
    out = torch.where((n > 0)[:, None], out, torch.full_like(out, float("nan")))
    return out[:, 0] if scalar else out


def _interp_rank(asc_at, n, q: float, dtype):
    """Linear interpolation at rank ``q·(n−1)`` given ``asc_at(j)``, the
    j-th ASCENDING order statistic per row."""
    nm1 = torch.clamp_min(n - 1, 0)
    rank = q * nm1.to(dtype)
    lo = torch.floor(rank).to(torch.int64)
    hi = torch.minimum(lo + 1, nm1)
    frac = rank - lo.to(dtype)
    out = asc_at(lo) * (1.0 - frac) + asc_at(hi) * frac
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def _edge_quantiles(values, ok, q_lo: float, q_hi: float, k: int):
    """Both tail quantiles from two top-k selections instead of a full sort;
    the ranks touched by q near 0/1 live in the outer ``k`` order
    statistics, and the selection is exact."""
    n = ok.sum(dim=-1)
    neg = torch.full_like(values, float("-inf"))
    top = torch.topk(torch.where(ok, values, neg), k, dim=-1).values   # desc
    bot = torch.topk(torch.where(ok, -values, neg), k, dim=-1).values  # -(asc)

    def take(mat, idx):
        return torch.gather(mat, -1, torch.clamp_min(idx, 0)[..., None])[..., 0]

    high = _interp_rank(lambda j: take(top, n - 1 - j), n, q_hi, values.dtype)
    low = _interp_rank(lambda j: -take(bot, j), n, q_lo, values.dtype)
    return low, high


def winsorize_cs(
    values: torch.Tensor,
    valid: torch.Tensor,
    lower_percentile: float = 1.0,
    upper_percentile: float = 99.0,
    min_obs: int = 5,
) -> torch.Tensor:
    """Per-month cross-sectional clip at the given percentiles.

    ``values`` is (..., T, N) with ``valid`` (T, N) broadcast over any
    leading axes. Months with fewer than ``min_obs`` valid observations pass
    through unclipped; NaN entries stay NaN.
    """
    q_lo = lower_percentile / 100.0
    q_hi = upper_percentile / 100.0
    ok = valid & torch.isfinite(values)
    n_cols = values.shape[-1]
    k = int(math.ceil(max(q_lo, 1.0 - q_hi) * max(n_cols - 1, 1))) + 2
    if 4 * k < n_cols:
        low, high = _edge_quantiles(values, ok, q_lo, q_hi, k)
    else:  # tails too deep for a top-k win: full masked sort
        flat = values.reshape(-1, n_cols)
        qs = masked_quantile(flat, ok.reshape(-1, n_cols), [q_lo, q_hi])
        low = qs[:, 0].reshape(values.shape[:-1])
        high = qs[:, 1].reshape(values.shape[:-1])
    n = ok.sum(dim=-1)
    clipped = torch.minimum(torch.maximum(values, low[..., None]), high[..., None])
    return torch.where((n >= min_obs)[..., None], clipped, values)


def winsorize_cs_batched(
    values: torch.Tensor,
    valid: torch.Tensor,
    lower_percentile: float = 1.0,
    upper_percentile: float = 99.0,
    min_obs: int = 5,
) -> torch.Tensor:
    """``winsorize_cs`` over a (V, T, N) stack of variables sharing one
    (T, N) validity mask, in one batched call."""
    return winsorize_cs(values, valid[None], lower_percentile,
                        upper_percentile, min_obs)
