"""Firm-axis strips for the daily kernels — full-CRSP scale on one device.

Firms are independent in every daily step (rolling windows and weekly sums
run along days WITHIN a firm column), so scale on one device is a host loop
over fixed-width firm strips of the compacted (CSR) daily layout: assemble
an (H, C) rectangle on the host, move it to the device, run the strip, pull
back the small (n_months, C) results. Peak device memory is set by the
strip, not by N.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.ops.daily_compact import (
    daily_compact_strip,
    daily_compact_strip_contiguous,
)

__all__ = ["daily_characteristics_compact_chunked"]


def _strip_plan(counts: np.ndarray, height_bucket: int = 1024,
               firm_chunk=None) -> Tuple[np.ndarray, int]:
    """The strip policy: firms ordered by row count DESCENDING (stable), cut
    into strips ``c`` firms wide. The default width targets ~2^25 slots per
    strip at the tallest strip's bucketed height, in multiples of 128
    firms. Returns ``(order, c)``."""
    n_firms = len(counts)
    if firm_chunk is None:
        h_max = _bucket(int(counts.max(initial=1)), height_bucket)
        firm_chunk = max(((1 << 25) // h_max) // 128 * 128, 128)
    c = min(int(firm_chunk), n_firms)
    return np.argsort(-counts, kind="stable"), c


def _bucket(h: int, height_bucket: int) -> int:
    return max(-(-int(h) // height_bucket) * height_bucket, height_bucket)


def daily_characteristics_compact_chunked(
    row_values,
    row_pos,
    offsets,
    mkt_d,
    mkt_present,
    day_month_id,
    week_id,
    week_month_id,
    n_days: int,
    n_weeks: int,
    n_months: int,
    device: torch.device,
    dtype: torch.dtype,
    window: int = 252,
    min_periods: int = 100,
    window_weeks: int = 156,
    firm_chunk=None,
    height_bucket: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """vol-252 and weekly beta from the compacted daily layout; returns
    numpy (n_months, N) pairs in the ORIGINAL firm order.

    Each strip's rectangle is only as tall as its longest-lived firm
    (rounded up to ``height_bucket``), so bytes moved track observed rows,
    not the dense (D, N) grid. Strips whose firms are all day-contiguous
    ship per-firm starts/counts instead of the position rectangle.
    """
    row_values = np.asarray(row_values)
    row_pos = np.asarray(row_pos)
    offsets = np.asarray(offsets)
    counts = np.diff(offsets)
    n_firms = len(counts)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    order, c = _strip_plan(counts, height_bucket, firm_chunk)

    def dev(a, dt=None):
        return torch.tensor(np.asarray(a), device=device, dtype=dt)

    mkt_t = dev(np.asarray(mkt_d, dtype=np_dtype))
    mkt_present_t = dev(mkt_present, torch.bool)
    month_t = dev(day_month_id, torch.int64)
    # days per week, counted once for every strip's segment sums (the
    # calendar's week ids never decrease: ``panel.daily.CompactDaily``)
    week_len_t = dev(np.bincount(np.asarray(week_id), minlength=int(n_weeks)),
                     torch.int64)
    week_month_t = dev(week_month_id, torch.int64)
    kwargs = dict(n_days=int(n_days), n_months=int(n_months), window=window,
                  min_periods=min_periods, window_weeks=window_weeks)

    # per-firm day-contiguity: positions strictly increase per firm, so a
    # firm is contiguous iff its position span equals count - 1 (an empty
    # firm counts as contiguous with start 0 / count 0)
    if n_firms and len(row_pos):
        cap = len(row_pos) - 1
        fi = np.minimum(offsets[:-1], cap)
        li = np.clip(offsets[1:] - 1, 0, cap)
        first_pos = np.where(counts > 0, row_pos[fi].astype(np.int64), 0)
        last_pos = np.where(counts > 0, row_pos[li].astype(np.int64), -1)
        firm_contiguous = (last_pos - first_pos) == (counts - 1)
    else:
        first_pos = np.zeros(n_firms, np.int64)
        firm_contiguous = np.zeros(n_firms, bool)

    vol_out = np.empty((n_months, n_firms), dtype=np_dtype)
    beta_out = np.empty((n_months, n_firms), dtype=np_dtype)
    for start in range(0, n_firms, c):
        firms = order[start : start + c]
        h = _bucket(int(counts[firms].max(initial=1)), height_bucket)
        rect_vals = np.full((h, c), np.nan, dtype=np_dtype)
        for k, f in enumerate(firms):
            a, b = offsets[f], offsets[f + 1]
            rect_vals[: b - a, k] = row_values[a:b]
        if len(firms) and bool(firm_contiguous[firms].all()):
            starts_arr = np.zeros(c, dtype=np.int64)
            counts_arr = np.zeros(c, dtype=np.int64)  # width padding: 0 rows
            starts_arr[: len(firms)] = first_pos[firms]
            counts_arr[: len(firms)] = counts[firms]
            vol_s, beta_s = daily_compact_strip_contiguous(
                dev(rect_vals), dev(starts_arr), dev(counts_arr),
                mkt_t, mkt_present_t, month_t, week_len_t, week_month_t, **kwargs,
            )
        else:
            rect_pos = np.full((h, c), n_days, dtype=np.int64)
            for k, f in enumerate(firms):
                a, b = offsets[f], offsets[f + 1]
                rect_pos[: b - a, k] = row_pos[a:b]
            vol_s, beta_s = daily_compact_strip(
                dev(rect_vals), dev(rect_pos),
                mkt_t, mkt_present_t, month_t, week_len_t, week_month_t, **kwargs,
            )
        vol_out[:, firms] = vol_s[:, : len(firms)].cpu().numpy()
        beta_out[:, firms] = beta_s[:, : len(firms)].cpu().numpy()
    return vol_out, beta_out
