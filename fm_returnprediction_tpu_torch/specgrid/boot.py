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
aggregate in one call. The JAX package also keeps a per-draw host loop
(``FMRP_BOOT_ROUTE=host``); the port has the batched route only. Both
functions run on ``device`` (``None`` → the GPU, ``device.resolve_device``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth_summary
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult

__all__ = ["resample_matrix", "bootstrap_aggregate_device", "bootstrap_aggregate_pairs"]


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
