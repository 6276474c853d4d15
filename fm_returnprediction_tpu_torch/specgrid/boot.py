"""Month-resampled Fama-MacBeth aggregation for bootstrap draws.

A bootstrap draw of a spec-grid cell differs from its point estimate only
in WHICH months enter the FM aggregation: its (T, P) slope series is
gathered along a circular moving-block month resample
(``engine.block_bootstrap_months``) and summarized again.
``bootstrap_aggregate_device`` does all of one spec's draws at once: one
batched gather of the D draw rows on the device, then the port's
``ops.fama_macbeth.fama_macbeth_summary`` over the leading draw axis (the
same mean / Newey-West / min-months / dropna semantics as every FM
summary). ``bootstrap_aggregate_pairs`` adds a leading pair axis: K series
that share one (D, T) gather plan — every pair of a Gram-bank query —
aggregate in one call. ``rolling_fm_windows`` reads Figure 1's rolling
slope means through the same gathered aggregation: each rolling point is a
gather row of the last ``window`` surviving months, its mean the FM
summary's ``coef`` with ``min_months=min_periods`` (the twin of
``ops.compaction.rolling_over_valid_rows``, which Figure 1 itself keeps, on
the rolling kernel K1). The JAX package also keeps a per-draw host loop and
a route knob (``FMRP_BOOT_ROUTE``); the port has the batched route only,
and one route per computation. Every function here runs on ``device``
(``None`` → the GPU, ``device.resolve_device``) in plain torch: the
reference's aggregation is a vmapped XLA program, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth_summary
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult

__all__ = ["resample_matrix", "bootstrap_aggregate_device", "bootstrap_aggregate_pairs",
           "rolling_fm_windows"]


def resample_matrix(t: int, draws: int, seed: int = 0,
                    block: Optional[int] = None) -> np.ndarray:
    """The (draws-1, T) stack of month resamples for draws 1..draws-1
    (draw 0 is the point estimate), each row from its draw's own generator
    (``engine.block_bootstrap_months``), as in the JAX package."""
    from fm_returnprediction_tpu_torch.specgrid.engine import block_bootstrap_months

    if draws < 2:
        return np.zeros((0, t), np.int64)
    return np.stack([block_bootstrap_months(t, d, seed=seed, block=block)
                     for d in range(1, draws)])


def bootstrap_aggregate_device(slopes, r2, n_obs, month_valid, idx,
                               nw_lags: int, min_months: int, weight: str,
                               device=None):
    """All of one spec's bootstrap draws at once on ``device``: gather the
    (D, T) resample rows of the (T, P) slope series and FM-aggregate each.
    Returns host numpy ``(coef (D, P), tstat (D, P), nw_se (D, P),
    mean_r2 (D,), mean_n (D,), n_months (D,))``: the FM summary's fields
    with a leading draw axis. Series with leading axes (slopes (..., T, P),
    the rest (..., T)) gather along their month axis, the draw axis after
    the leading ones."""
    rows = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=resolve_device(device))
    dev = rows.device
    slopes, r2, n_obs = (torch.as_tensor(np.asarray(a), device=dev)
                         for a in (slopes, r2, n_obs))
    month_valid = torch.as_tensor(np.asarray(month_valid, bool), device=dev)
    cs = CSRegressionResult(
        slopes=slopes[..., rows, :],
        intercept=torch.zeros((*slopes.shape[:-2], *rows.shape), dtype=slopes.dtype,
                              device=dev),
        r2=r2[..., rows], n_obs=n_obs[..., rows], month_valid=month_valid[..., rows],
    )
    fm = fama_macbeth_summary(cs, nw_lags=nw_lags, min_months=min_months, weight=weight)
    host = [a.detach().cpu().numpy() for a in fm]
    return (*host[:5], host[5].astype(np.int64))


def bootstrap_aggregate_pairs(slopes, r2, n_obs, month_valid, idx,
                              nw_lags: int, min_months: int, weight: str,
                              device=None):
    """All draws of ALL K series at once on ``device``: ``slopes`` (K, T,
    P), ``r2``/``n_obs``/``month_valid`` (K, T), ``idx`` (D, T) draw rows
    shared by every series. Returns host numpy ``(coef (K, D, P), tstat,
    nw_se, mean_r2 (K, D), mean_n, n_months)`` — per series the rows of
    :func:`bootstrap_aggregate_device` on that series."""
    return bootstrap_aggregate_device(slopes, r2, n_obs, month_valid, idx, nw_lags,
                                      min_months, weight, device=device)


def _rolling_gather(valid: np.ndarray, window: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host gather plan for rolling over surviving rows: one (V, W) index
    row per surviving month (its window: the last ``window`` surviving
    months up to and including it), the (V, W) in-window mask, and the (V,)
    calendar positions the results scatter back to."""
    pos = np.flatnonzero(np.asarray(valid, bool))
    v = pos.size
    idx = np.zeros((v, window), np.int64)
    keep = np.zeros((v, window), bool)
    for j in range(v):
        rows = pos[max(0, j - window + 1):j + 1]
        idx[j, :rows.size] = rows
        keep[j, :rows.size] = True
    return idx, keep, pos


def rolling_fm_windows(slopes, month_valid, window: int, min_periods: int,
                       device=None) -> np.ndarray:
    """Rolling slope means through the gathered aggregation of the
    bootstrap draws, on ``device``: each surviving month's point is the FM
    summary's ``coef`` over the last ``window`` surviving months with
    ``min_months=min_periods`` (a padded slot is masked off, as a month the
    summary drops). ``slopes`` (T, P), ``month_valid`` (T,). Returns the
    calendar-placed host (T, P) array, NaN at invalid months and where
    fewer than ``min_periods`` months entered."""
    slopes = np.asarray(slopes)
    month_valid = np.asarray(month_valid, bool)
    t, p = slopes.shape
    out = np.full((t, p), np.nan, slopes.dtype)
    dev = resolve_device(device)
    if not month_valid.any():
        return out
    idx, keep, pos = _rolling_gather(month_valid, int(window))
    rows = torch.as_tensor(idx, device=dev)
    s = torch.as_tensor(slopes, device=dev)
    mv = torch.as_tensor(month_valid, device=dev)
    zeros = torch.zeros(rows.shape, dtype=s.dtype, device=dev)
    cs = CSRegressionResult(slopes=s[rows], intercept=zeros, r2=zeros, n_obs=zeros,
                            month_valid=mv[rows] & torch.as_tensor(keep, device=dev))
    fm = fama_macbeth_summary(cs, nw_lags=0, min_months=int(min_periods), weight="reference")
    out[pos] = fm.coef.detach().cpu().numpy()
    return out
