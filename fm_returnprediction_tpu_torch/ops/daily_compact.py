"""Compacted-ingest daily strips: 252-day volatility and weekly beta.

Each firm's rows arrive ALREADY COMPACTED — ``comp_ret`` (H, C) with each
firm's observed rows packed to the front in chronological order — so
pandas' per-firm 252-row window (reference ``calc_std_12``) runs directly
on the ingested layout through ``rolling_std`` (the rolling kernel on the
GPU). The calendar-indexed steps (last observation per month, weekly beta)
run on a dense (D, C) strip rebuilt on the device.

Padding rows carry ``pos == n_days``; the scatter target of the general
route has one trash row at index ``n_days`` that is sliced off.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from fm_returnprediction_tpu_torch.ops.daily_kernels import (
    last_obs_per_month,
    weekly_rolling_beta_monthly,
)
from fm_returnprediction_tpu_torch.ops.rolling import rolling_std

__all__ = ["daily_compact_strip", "daily_compact_strip_contiguous"]


def _annualized_vol(comp_ret, row_present, window: int, min_periods: int):
    nan = torch.full_like(comp_ret, float("nan"))
    scale = torch.sqrt(torch.tensor(float(window), dtype=comp_ret.dtype,
                                    device=comp_ret.device))
    return rolling_std(torch.where(row_present, comp_ret, nan), window,
                       min_periods) * scale


def daily_compact_strip_contiguous(
    comp_ret: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    mkt_d: torch.Tensor,
    mkt_present: torch.Tensor,
    day_month_id: torch.Tensor,
    week_id: torch.Tensor,
    week_month_id: torch.Tensor,
    n_days: int,
    n_weeks: int,
    n_months: int,
    window: int = 252,
    min_periods: int = 100,
    window_weeks: int = 156,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``daily_compact_strip`` for strips whose firms' rows are DAY-
    CONTIGUOUS (the norm in CRSP: rows exist for every trading day while
    listed). Per-firm ``starts``/``counts`` (C,) replace the position
    rectangle, and the calendar layout is a pure offset gather:
    ``dense[d, k] = comp_ret[d - starts[k], k]``."""
    h = comp_ret.shape[0]
    dev = comp_ret.device
    counts = counts.to(torch.int64)
    starts = starts.to(torch.int64)
    row_present = torch.arange(h, device=dev)[:, None] < counts[None, :]
    vol_rows = _annualized_vol(comp_ret, row_present, window, min_periods)

    idx = torch.arange(n_days, device=dev)[:, None] - starts[None, :]
    mask = (idx >= 0) & (idx < counts[None, :])
    idx_c = torch.clamp(idx, 0, h - 1)

    def to_cal(x):
        got = torch.gather(x, 0, idx_c)
        return torch.where(mask, got, torch.full_like(got, float("nan")))

    vol = last_obs_per_month(to_cal(vol_rows), mask, day_month_id, n_months)
    beta = weekly_rolling_beta_monthly(
        to_cal(comp_ret), mask, mkt_d, week_id, n_weeks, week_month_id,
        n_months, window_weeks=window_weeks, mkt_present=mkt_present,
    )
    return vol, beta


def daily_compact_strip(
    comp_ret: torch.Tensor,
    pos: torch.Tensor,
    mkt_d: torch.Tensor,
    mkt_present: torch.Tensor,
    day_month_id: torch.Tensor,
    week_id: torch.Tensor,
    week_month_id: torch.Tensor,
    n_days: int,
    n_weeks: int,
    n_months: int,
    window: int = 252,
    min_periods: int = 100,
    window_weeks: int = 156,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """vol-252 and weekly beta for one compacted firm strip.

    comp_ret : (H, C) firm rows packed to the front (chronological).
    pos      : (H, C) int day index of each row; ``n_days`` marks padding.
    week_id  : (D,) int week of each day, in any order (ids outside
               ``[0, n_weeks)`` drop the day from the weekly sums).
    Returns ``(vol, beta)``, each (n_months, C).
    """
    pos = pos.to(torch.int64)
    row_present = pos < n_days
    cols = torch.arange(comp_ret.shape[1], device=comp_ret.device)[None, :]
    cols = cols.expand_as(pos)

    def to_dense(x, fill):
        out = torch.full((n_days + 1, x.shape[1]), fill, dtype=x.dtype,
                         device=x.device)
        out.index_put_((pos, cols), x)   # padding → trash row n_days
        return out[:n_days]

    mask = to_dense(row_present, False)
    nan = torch.full_like(comp_ret, float("nan"))
    vol_rows = _annualized_vol(comp_ret, row_present, window, min_periods)
    vol_cal = to_dense(torch.where(row_present, vol_rows, nan), math.nan)
    vol = last_obs_per_month(vol_cal, mask, day_month_id, n_months)

    ret_cal = to_dense(torch.where(row_present, comp_ret, nan), math.nan)
    beta = weekly_rolling_beta_monthly(
        ret_cal, mask, mkt_d, week_id, n_weeks, week_month_id, n_months,
        window_weeks=window_weeks, mkt_present=mkt_present,
    )
    return vol, beta
