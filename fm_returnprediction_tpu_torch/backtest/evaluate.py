"""Out-of-sample evaluation metrics and their inference.

The evaluation half of the backtest, each device function mirrored by a
numpy host oracle:

- ``oos_r2`` — Campbell-Thompson out-of-sample R² against the EXPANDING
  HISTORICAL-MEAN benchmark: the benchmark forecast for month t is the
  pooled mean of the evaluable sample's realized returns over months < t
  (months before any history are excluded from both sums);
- ``ic_series`` — per-month Pearson information coefficient between the
  forecast and the realized return, and the rank IC on ORDINAL ranks from a
  stable double argsort (``torch.argsort(..., stable=True)``): ties break
  by firm position, as in the JAX package and the oracle;
- ``series_inference`` — mean, Newey-West SE and t-stat of a backtest
  series through ``ops.newey_west.nw_mean_se``;
- ``bootstrap_series`` — the circular-block bootstrap over ORIGINS through
  the batched month-resample aggregator (``specgrid.boot``) on the
  spec-grid engine's draw seeds, so draw 0 is the point estimate.

The device functions run where their tensors lie; ``series_inference`` and
``bootstrap_series`` take host series and run on ``device`` (``None`` →
the GPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.ops.newey_west import nw_mean_se
from fm_returnprediction_tpu_torch.specgrid.boot import (
    bootstrap_aggregate_device,
    resample_matrix,
)

__all__ = [
    "bootstrap_series",
    "ic_series",
    "ic_series_np",
    "oos_r2",
    "oos_r2_np",
    "series_inference",
]


def oos_r2(er: torch.Tensor, er_valid: torch.Tensor, realized: torch.Tensor) -> torch.Tensor:
    """Out-of-sample R² of the forecast against the expanding
    historical-mean benchmark over the evaluable sample (forecast AND
    realized present): ``1 − Σ(r − ê)² / Σ(r − r̄_hist)²``, where
    ``r̄_hist`` at month t is the pooled mean of evaluable realized returns
    over months < t. A 0-d tensor, NaN when no month has prior history or
    the benchmark sum is zero."""
    ok = er_valid & torch.isfinite(realized)
    dtype = er.dtype
    zero = torch.zeros((), dtype=dtype, device=er.device)
    msum = torch.where(ok, realized, zero).sum(dim=1)           # (T,)
    mcnt = ok.sum(dim=1).to(dtype)
    # strictly-past pooled mean: the prefix sums shifted one month
    prev_sum = torch.cat([zero[None], torch.cumsum(msum, 0)[:-1]])
    prev_cnt = torch.cat([zero[None], torch.cumsum(mcnt, 0)[:-1]])
    hist = torch.where(prev_cnt > 0, prev_sum / torch.clamp_min(prev_cnt, 1.0),
                       torch.full_like(prev_sum, float("nan")))
    use = ok & (prev_cnt > 0)[:, None]
    err_model = torch.where(use, realized - er, zero)
    err_bench = torch.where(use, realized - hist[:, None], zero)
    num = (err_model * err_model).sum()
    den = (err_bench * err_bench).sum()
    return torch.where(den > 0, 1.0 - num / torch.where(den > 0, den, 1.0),
                       torch.full_like(den, float("nan")))


def oos_r2_np(er, er_valid, realized) -> float:
    """Numpy mirror of :func:`oos_r2` — the host oracle."""
    er = np.asarray(er, float)
    realized = np.asarray(realized, float)
    ok = np.asarray(er_valid, bool) & np.isfinite(realized)
    num = den = 0.0
    run_sum = run_cnt = 0.0
    for m in range(er.shape[0]):
        if run_cnt > 0:
            hist = run_sum / run_cnt
            rows = ok[m]
            num += float(((realized[m, rows] - er[m, rows]) ** 2).sum())
            den += float(((realized[m, rows] - hist) ** 2).sum())
        run_sum += float(realized[m, ok[m]].sum())
        run_cnt += float(ok[m].sum())
    return 1.0 - num / den if den > 0 else float("nan")


def _masked_corr(a: torch.Tensor, b: torch.Tensor, ok: torch.Tensor, min_obs: int):
    """Per-month Pearson correlation of two (T, N) panels over ``ok``."""
    dtype = a.dtype
    zero = torch.zeros((), dtype=dtype, device=a.device)
    n = ok.sum(dim=1).to(dtype)
    nz = torch.clamp_min(n, 1.0)
    ma = torch.where(ok, a, zero).sum(dim=1) / nz
    mb = torch.where(ok, b, zero).sum(dim=1) / nz
    da = torch.where(ok, a - ma[:, None], zero)
    db = torch.where(ok, b - mb[:, None], zero)
    cov = (da * db).sum(dim=1)
    va = (da * da).sum(dim=1)
    vb = (db * db).sum(dim=1)
    good = (n >= min_obs) & (va > 0) & (vb > 0)
    corr = cov / torch.sqrt(torch.where(good, va * vb, torch.ones_like(va)))
    return torch.where(good, corr, torch.full_like(corr, float("nan"))), good


def _ordinal_ranks(values: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Per-month ordinal ranks of the valid entries (invalid pushed to the
    back); ties break by firm position through the stable argsort."""
    big = torch.where(ok, values, torch.full_like(values, float("inf")))
    order = torch.argsort(big, dim=1, stable=True)
    ramp = torch.arange(values.shape[1], device=values.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(1, order, ramp)
    return ranks.to(values.dtype)


def ic_series(er: torch.Tensor, er_valid: torch.Tensor, realized: torch.Tensor,
              min_obs: int = 10):
    """Per-month Pearson and rank (Spearman on ordinal ranks) information
    coefficients: ``(ic (T,), rank_ic (T,), ic_valid (T,))``. NaN months
    have fewer than ``min_obs`` evaluable firms or a zero-variance side."""
    ok = er_valid & torch.isfinite(realized)
    ic, good = _masked_corr(er, realized, ok, min_obs)
    rank_ic, _ = _masked_corr(_ordinal_ranks(er, ok), _ordinal_ranks(realized, ok), ok,
                              min_obs)
    return ic, rank_ic, good


def ic_series_np(er, er_valid, realized, min_obs: int = 10):
    """Numpy mirror of :func:`ic_series` — the host oracle (ranks by stable
    sort order, firm index breaking ties)."""
    er = np.asarray(er, float)
    realized = np.asarray(realized, float)
    ok = np.asarray(er_valid, bool) & np.isfinite(realized)
    t = er.shape[0]
    ic = np.full(t, np.nan)
    rank_ic = np.full(t, np.nan)
    for m in range(t):
        rows = np.flatnonzero(ok[m])
        if rows.size < min_obs:
            continue
        a, b = er[m, rows], realized[m, rows]
        if a.std() == 0 or b.std() == 0:
            continue
        ic[m] = np.corrcoef(a, b)[0, 1]
        ra = np.empty(rows.size)
        ra[np.argsort(a, kind="stable")] = np.arange(rows.size)
        rb = np.empty(rows.size)
        rb[np.argsort(b, kind="stable")] = np.arange(rows.size)
        if ra.std() == 0 or rb.std() == 0:
            continue
        rank_ic[m] = np.corrcoef(ra, rb)[0, 1]
    return ic, rank_ic


def series_inference(series, valid=None, nw_lags: int = 4, weight: str = "reference",
                     device=None):
    """Mean / NW SE / t-stat of one backtest series on ``device`` through
    ``ops.newey_west.nw_mean_se``. ``valid`` defaults to the finite
    entries. Returns host floats ``(mean, nw_se, tstat, n)``."""
    dev = resolve_device(device)
    series = torch.as_tensor(np.asarray(series), device=dev)
    fin = torch.isfinite(series)
    valid = fin if valid is None else torch.as_tensor(np.asarray(valid, bool), device=dev) & fin
    n = int(valid.sum())
    mean = (float(torch.where(valid, series, torch.zeros_like(series)).sum() / max(n, 1))
            if n else float("nan"))
    se = float(nw_mean_se(series, valid, lags=nw_lags, weight=weight))
    tstat = mean / se if n and np.isfinite(se) and se else float("nan")
    return mean, se, tstat, n


def bootstrap_series(
    series,
    valid=None,
    draws: int = 100,
    seed: int = 0,
    block: Optional[int] = None,
    nw_lags: int = 4,
    weight: str = "reference",
    device=None,
):
    """Circular-block bootstrap of a backtest series over ORIGINS on
    ``device``, through the batched month-resample aggregator on the
    spec-grid engine's draw seeds.

    ``series`` may be (T,) or (T, P) (several series share one gather
    plan). Returns ``(point (P,), boot_se (P,), draw_means (draws-1, P))``:
    the never-resampled draw-0 mean and the ddof-1 std of the resampled
    draw means (NaN below 3 draws)."""
    if draws < 1:
        raise ValueError("draws counts the point estimate; must be >= 1")
    arr = np.asarray(series, float)
    if arr.ndim == 1:
        arr = arr[:, None]
    t, p = arr.shape
    month_valid = np.isfinite(arr).any(axis=1) if valid is None else np.asarray(valid, bool)
    point = np.array([
        arr[np.isfinite(arr[:, j]) & month_valid, j].mean()
        if (np.isfinite(arr[:, j]) & month_valid).any() else np.nan
        for j in range(p)])
    if draws < 2:
        return point, np.full(p, np.nan), np.zeros((0, p))
    idx = resample_matrix(t, int(draws), seed=seed, block=block)
    draw_means = bootstrap_aggregate_device(arr, np.zeros(t), np.zeros(t), month_valid, idx,
                                            nw_lags=nw_lags, min_months=1, weight=weight,
                                            device=device)[0]
    boot_se = np.nanstd(draw_means, axis=0, ddof=1) if draws >= 3 else np.full(p, np.nan)
    return point, boot_se, draw_means
