"""Firm-axis strips for the daily kernels — full-CRSP scale on one device.

Firms are independent in every daily step (rolling windows and weekly sums
run along days WITHIN a firm column), so scale on one device is a host loop
over fixed-width firm strips of the compacted (CSR) daily layout: assemble
an (H, C) rectangle on the host, move it to the device, run the strip, pull
back the small (n_months, C) results. Peak device memory is set by the
strip, not by N.

With a ``mesh`` each strip's firm axis is split over the mesh's firm axis:
strips widen by the shard count (full blocks on every shard), and each
shard runs the strip functions on its (H, C/d) block on its device, so on
the card the rolling kernel launches once per shard per strip. Firms are
independent, so no collective runs.
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
               firm_chunk=None, n_shards: int = 1) -> Tuple[np.ndarray, int]:
    """The strip policy: firms ordered by row count DESCENDING (stable), cut
    into strips ``c`` firms wide. The default width targets ~2^25 slots per
    strip and shard at the tallest strip's bucketed height, in multiples of
    128 firms per shard; ``c`` rounds up to a multiple of ``n_shards``.
    Returns ``(order, c)``."""
    n_firms = len(counts)
    if firm_chunk is None:
        h_max = _bucket(int(counts.max(initial=1)), height_bucket)
        firm_chunk = max(((1 << 25) // h_max) // 128 * 128, 128) * n_shards
    c = min(int(firm_chunk), n_firms)
    c = -(-c // n_shards) * n_shards
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
    mesh=None,
    axis_name: str = "firms",
) -> Tuple[np.ndarray, np.ndarray]:
    """vol-252 and weekly beta from the compacted daily layout; returns
    numpy (n_months, N) pairs in the ORIGINAL firm order.

    Each strip's rectangle is only as tall as its longest-lived firm
    (rounded up to ``height_bucket``), so bytes moved track observed rows,
    not the dense (D, N) grid. Strips whose firms are all day-contiguous
    ship per-firm starts/counts instead of the position rectangle. With a
    1-D ``mesh`` of this process's devices the strips shard over its
    ``axis_name`` axis (module docstring) and ``device`` is not used.
    """
    row_values = np.asarray(row_values)
    row_pos = np.asarray(row_pos)
    offsets = np.asarray(offsets)
    counts = np.diff(offsets)
    n_firms = len(counts)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    if mesh is None:
        shard_devices = [torch.device(device)]
    else:
        if mesh.axis_names != (axis_name,) or len(mesh.local_positions()) != mesh.size:
            raise ValueError(f"the daily strips shard over a 1-D '{axis_name}' mesh of this "
                             f"process's devices, got {mesh!r}")
        shard_devices = mesh.local_devices()
    n_shards = len(shard_devices)
    order, c = _strip_plan(counts, height_bucket, firm_chunk, n_shards)
    cw = c // n_shards

    # the per-day vectors, once per device (shards of one card share them);
    # week lengths: days per week, counted once for every strip's segment
    # sums (the calendar's week ids never decrease: ``panel.daily.CompactDaily``)
    host_vectors = {
        "mkt_d": (np.asarray(mkt_d, dtype=np_dtype), None),
        "mkt_present": (np.asarray(mkt_present), torch.bool),
        "day_month_id": (np.asarray(day_month_id), torch.int64),
        "week_lengths": (np.bincount(np.asarray(week_id), minlength=int(n_weeks)), torch.int64),
        "week_month_id": (np.asarray(week_month_id), torch.int64),
    }
    per_device = {}
    for d in shard_devices:
        if d not in per_device:
            per_device[d] = [torch.tensor(a, device=d, dtype=dt)
                             for a, dt in host_vectors.values()]
    kwargs = dict(n_days=int(n_days), n_months=int(n_months), window=window,
                  min_periods=min_periods, window_weeks=window_weeks)

    def run_strip(strip_fn, *blocks):
        """The strip function on each shard's column block, results
        concatenated in shard order on the host."""
        vols, betas = [], []
        for i, d in enumerate(shard_devices):
            cols = slice(i * cw, (i + 1) * cw)
            args = [torch.tensor(np.ascontiguousarray(b[..., cols]), device=d) for b in blocks]
            vol, beta = strip_fn(*args, *per_device[d], **kwargs)
            vols.append(vol.cpu().numpy())
            betas.append(beta.cpu().numpy())
        return np.concatenate(vols, axis=1), np.concatenate(betas, axis=1)

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
            vol_s, beta_s = run_strip(daily_compact_strip_contiguous, rect_vals,
                                      starts_arr, counts_arr)
        else:
            rect_pos = np.full((h, c), n_days, dtype=np.int64)
            for k, f in enumerate(firms):
                a, b = offsets[f], offsets[f + 1]
                rect_pos[: b - a, k] = row_pos[a:b]
            vol_s, beta_s = run_strip(daily_compact_strip, rect_vals, rect_pos)
        vol_out[:, firms] = vol_s[:, : len(firms)]
        beta_out[:, firms] = beta_s[:, : len(firms)]
    return vol_out, beta_out
