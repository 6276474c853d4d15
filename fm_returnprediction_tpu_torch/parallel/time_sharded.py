"""Rolling reductions with the TIME axis sharded across a mesh axis.

The firm-sharded daily kernels split the firm axis. This module covers the
long-sequence regime, where the time axis itself shards, and the
trailing-window reductions of ``ops.rolling`` run with two collectives per
call:

1. **distributed prefix sum**: each shard takes the inclusive masked
   cumulative moments of its block (Σx, Σx², count) — the function of the
   cumulative-moments kernel, so on the card one kernel launch per shard —
   and one ``all_gather`` of the shards' totals gives every shard the
   exclusive offset that turns its local cumulative sums into global ones;
2. **halo exchange**: the windowed difference ``c[t] − c[t−w]`` needs the
   previous shard's last ``window`` global rows for a shard's first
   ``window`` outputs; one ``ppermute`` moves exactly that block forward
   along the axis (the first shard receives zeros, which is the right
   ``c[t−w]`` for global ``t < window``).

The count channel stays an exact integer: the kernel returns it in the
data's dtype, exact below 2^24 rows in float32, so each shard's count is
cast to int64 before the global offset, and a float32 shard longer than
2^24 rows raises rather than lose exactness. The finalizations are
``ops.rolling``'s own (``finalize_sum``/``_mean``/``_std``), so the window
semantics (pandas ``rolling(window, min_periods)``, NaNs excluded) are the
single-device ones to rounding.

``window`` must fit in one shard (the halo is a single hop); a longer one
raises. The sequence pads to a multiple of the shard count with NaN rows,
which only ever trail and are trimmed from the result.

``weekly_rolling_beta_time_sharded``: each shard sums its days into the
global weekly segments (a week straddling a seam gets rows from two
shards), one ``psum`` of the six (n_weeks, N) weekly partials reproduces
the one-device sums, and the weekly windowing runs once after it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fm_returnprediction_tpu_torch.ops.daily_kernels import (
    beta_from_weekly_sums,
    weekly_partial_sums,
)
from fm_returnprediction_tpu_torch.ops.rolling import (
    finalize_mean,
    finalize_std,
    finalize_sum,
    masked_cumulative_moments,
)
from fm_returnprediction_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    all_gather,
    axis_index,
    make_mesh,
    pad_to_multiple,
    place_global,
    ppermute,
    psum,
)

__all__ = [
    "F32_EXACT_COUNT_ROWS",
    "rolling_moments_time_sharded",
    "rolling_sum_time_sharded",
    "rolling_mean_time_sharded",
    "rolling_std_time_sharded",
    "weekly_rolling_beta_time_sharded",
]

#: the longest float32 shard whose kernel count is still an exact integer
F32_EXACT_COUNT_ROWS = 1 << 24


def _windowed(mesh: Mesh, axis: str, window: int, cs: list) -> list:
    """Local cumulative sums (per shard a tuple of tensors) → global
    windowed differences: the prefix-sum ``all_gather`` and the halo
    ``ppermute`` (module docstring)."""
    p = mesh.shape[axis]
    idx = axis_index(mesh, axis)
    totals = all_gather(mesh, [tuple(c[-1] for c in part) for part in cs], axis)
    glob = []
    for i, part, tot in zip(idx, cs, totals):
        before = torch.arange(p, device=part[0].device) < i
        glob.append(tuple(
            c + torch.where(before.reshape((p,) + (1,) * (t.ndim - 1)), t,
                            torch.zeros_like(t)).sum(dim=0)[None]
            for c, t in zip(part, tot)))
    halo = ppermute(mesh, [tuple(g[-window:] for g in part) for part in glob], axis,
                    [(i, i + 1) for i in range(p - 1)])
    return [tuple(g - torch.cat([h, g], dim=0)[: g.shape[0]] for g, h in zip(gp, hp))
            for gp, hp in zip(glob, halo)]


def _local_moments(x_l: torch.Tensor, need_s2: bool):
    """One shard's inclusive (Σx[, Σx²]) and int64 count by the
    cumulative-moments kernel (the plain version on the CPU)."""
    if x_l.dtype == torch.float32 and x_l.shape[0] > F32_EXACT_COUNT_ROWS:
        raise ValueError(
            f"a float32 shard of {x_l.shape[0]} rows passes {F32_EXACT_COUNT_ROWS} (2^24), "
            "beyond which the kernel's float32 count is no longer an exact integer; "
            "shard the sequence over more devices or use float64")
    s1, s2, count = masked_cumulative_moments(x_l)
    count = count.to(torch.int64)
    return (s1, s2, count) if need_s2 else (s1, count)


def _rolling(mesh: Mesh, axis: str, window: int, stat: str, min_periods: int,
             shards: list) -> list:
    need_s2 = stat in ("moments", "std")
    out = []
    for w in _windowed(mesh, axis, window, [_local_moments(x, need_s2) for x in shards]):
        if stat == "moments":
            out.append(w)
        elif stat == "sum":
            out.append(finalize_sum(w[0], w[1], min_periods))
        elif stat == "mean":
            out.append(finalize_mean(w[0], w[1], min_periods))
        else:
            out.append(finalize_std(w[0], w[1], w[2], min_periods))
    return out


def _prepare(x, window: int, mesh: Optional[Mesh], axis_name: str):
    x = torch.as_tensor(x)
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name, device=x.device.type)
    p = mesh.shape[axis_name]
    t = x.shape[0]
    x = pad_to_multiple(x, axis=0, multiple=p, fill=float("nan"))
    shard_len = x.shape[0] // p
    if window > shard_len:
        raise ValueError(
            f"window={window} exceeds the per-shard sequence length {shard_len} "
            f"({x.shape[0]} rows over {p} '{axis_name}' shards); the single-hop halo "
            "carries at most one shard of history")
    return place_global(x, NamedSharding(mesh, P(axis_name, None))), t, mesh


def _run(x, window, stat, min_periods, mesh, axis_name):
    placed, t, mesh = _prepare(x, window, mesh, axis_name)
    parts = _rolling(mesh, axis_name, int(window), stat, int(min_periods), placed.shards)
    home = placed.shards[0].device
    if stat == "moments":
        return tuple(torch.cat([p[k].to(home) for p in parts], dim=0)[:t] for k in range(3))
    return torch.cat([p.to(home) for p in parts], dim=0)[:t]


def rolling_moments_time_sharded(x, window: int, mesh: Optional[Mesh] = None,
                                 axis_name: str = "time"):
    """Trailing-window (Σx, Σx², count) with the time axis sharded; ``x``
    (D, N) → three (D, N) tensors on the mesh's first device (count
    int64). ``mesh=None`` is every local device of ``x``'s kind."""
    return _run(x, window, "moments", 0, mesh, axis_name)


def rolling_sum_time_sharded(x, window: int, min_periods: int, mesh: Optional[Mesh] = None,
                             axis_name: str = "time"):
    """``ops.rolling.rolling_sum`` with the time axis sharded."""
    return _run(x, window, "sum", min_periods, mesh, axis_name)


def rolling_mean_time_sharded(x, window: int, min_periods: int, mesh: Optional[Mesh] = None,
                              axis_name: str = "time"):
    """``ops.rolling.rolling_mean`` with the time axis sharded."""
    return _run(x, window, "mean", min_periods, mesh, axis_name)


def rolling_std_time_sharded(x, window: int, min_periods: int, mesh: Optional[Mesh] = None,
                             axis_name: str = "time"):
    """``ops.rolling.rolling_std`` (ddof=1) with the time axis sharded."""
    return _run(x, window, "std", min_periods, mesh, axis_name)


def weekly_rolling_beta_time_sharded(
    ret_d,
    mask_d,
    mkt_d,
    week_id,
    n_weeks: int,
    week_month_id,
    n_months: int,
    window_weeks: int = 156,
    mkt_present=None,
    mesh: Optional[Mesh] = None,
    axis_name: str = "time",
):
    """``ops.daily_kernels.weekly_rolling_beta_monthly`` with the DAY axis
    sharded (module docstring). ``week_id`` (D,) may come in any order:
    each shard sums its own days by week (ids outside ``[0, n_weeks)``
    dropped) and one ``psum`` adds the shards in axis order.
    Returns the (n_months, N) betas on the mesh's first device."""
    ret_d = torch.as_tensor(ret_d)
    mask_d = torch.as_tensor(mask_d, dtype=torch.bool)
    mkt_d = torch.as_tensor(mkt_d, dtype=ret_d.dtype)
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name, device=ret_d.device.type)
    p = mesh.shape[axis_name]
    week_np = np.asarray(week_id).astype(np.int64)
    ret_d = pad_to_multiple(ret_d, axis=0, multiple=p, fill=float("nan"))
    mask_d = pad_to_multiple(mask_d, axis=0, multiple=p, fill=False)
    mkt_d = pad_to_multiple(mkt_d, axis=0, multiple=p, fill=float("nan"))
    # NaN-padded market days are not present, so the pads add zeros
    if mkt_present is None:
        mkt_present = torch.isfinite(mkt_d)
    else:
        mkt_present = pad_to_multiple(torch.as_tensor(mkt_present, dtype=torch.bool),
                                      axis=0, multiple=p, fill=False)
    # pad days take an id past the last week: the sums drop them
    week_np = pad_to_multiple(week_np, axis=0, multiple=p, fill=int(n_weeks))
    strip = NamedSharding(mesh, P(axis_name, None))
    row = NamedSharding(mesh, P(axis_name))
    rets = place_global(ret_d, strip).shards
    masks = place_global(mask_d, strip).shards
    mkts = place_global(mkt_d, row).shards
    presents = place_global(mkt_present, row).shards
    weeks = place_global(week_np, row).shards
    partials = []
    for r, m, mk, pr, w in zip(rets, masks, mkts, presents, weeks):
        partials.append(weekly_partial_sums(r, m, mk, w, int(n_weeks), mkt_present=pr))
    sums = psum(mesh, partials, axis_name)[0]
    home = rets[0].device
    week_month = torch.as_tensor(week_month_id, dtype=torch.int64, device=home)
    return beta_from_weekly_sums(*sums, week_month, int(n_months), int(window_weeks))
