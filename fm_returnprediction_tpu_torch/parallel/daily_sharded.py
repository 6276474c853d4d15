"""Firm-sharded daily kernels, with no collective at all.

On the dense (D, N) daily panel every daily step (the per-firm 252-row
volatility, the weekly segment sums and windows of the rolling beta) runs
along days WITHIN a firm column, so the daily stage shards over the mesh's
firm axis with zero communication: each shard holds a (D, N/d) strip, the
per-day vectors (market return, month and week ids) replicate, and the
(n_months, N/d) outputs come back firm-sharded. On the card each shard's
volatility is one launch of the rolling kernel. The compacted-ingest route
of the pipeline (``ops.daily_chunked`` with ``mesh=``) shards its strips
the same way; this module serves callers that hold a dense panel.
"""

from __future__ import annotations

import numpy as np
import torch

from fm_returnprediction_tpu_torch.ops.daily_kernels import (
    rolling_vol_252_monthly,
    weekly_rolling_beta_monthly,
)
from fm_returnprediction_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    Placed,
    pad_to_multiple,
    place_global,
)

__all__ = ["daily_characteristics_sharded"]


def daily_characteristics_sharded(
    ret_d,
    mask_d,
    mkt_d,
    month_id,
    week_id,
    week_month_id,
    n_months: int,
    n_weeks: int,
    mesh: Mesh,
    mkt_present=None,
    window: int = 252,
    min_periods: int = 100,
    window_weeks: int = 156,
    axis_name: str = "firms",
    dtype=None,
):
    """vol-252 and weekly beta with the firm axis sharded over ``mesh``.

    ``ret_d``, ``mask_d`` (D, N) and the per-day vectors are host numpy
    arrays or tensors; ``dtype`` (default ``ret_d``'s) is the compute
    dtype. Returns ``(vol, beta)``, each a firm-sharded ``Placed`` of
    (n_months, N padded to the mesh); ``to_global()[:, :N]`` drops the pad
    columns."""
    ret_d = torch.as_tensor(ret_d, dtype=dtype)
    d = mesh.shape[axis_name]
    ret_d = pad_to_multiple(ret_d, axis=1, multiple=d, fill=float("nan"))
    mask_d = pad_to_multiple(torch.as_tensor(mask_d, dtype=torch.bool), axis=1, multiple=d,
                             fill=False)
    mkt = torch.as_tensor(mkt_d, dtype=ret_d.dtype)
    present = (torch.isfinite(mkt) if mkt_present is None
               else torch.as_tensor(mkt_present, dtype=torch.bool))
    week = torch.as_tensor(np.asarray(week_id), dtype=torch.int64)
    month = torch.as_tensor(month_id, dtype=torch.int64)
    week_month = torch.as_tensor(week_month_id, dtype=torch.int64)

    strip = NamedSharding(mesh, P(None, axis_name))
    ret_p = place_global(ret_d, strip)
    mask_p = place_global(mask_d, strip)
    vols, betas = [], []
    for dev, r, m in zip(mesh.local_devices(), ret_p.shards, mask_p.shards):
        vols.append(rolling_vol_252_monthly(r, m, month.to(dev), int(n_months),
                                            window=window, min_periods=min_periods))
        betas.append(weekly_rolling_beta_monthly(
            r, m, mkt.to(dev), week.to(dev), int(n_weeks), week_month.to(dev), int(n_months),
            window_weeks=window_weeks, mkt_present=present.to(dev)))
    shape = (int(n_months), ret_d.shape[1])
    return Placed(vols, strip, shape), Placed(betas, strip, shape)
