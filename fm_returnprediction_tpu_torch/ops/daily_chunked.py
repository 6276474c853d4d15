"""Firm-axis strips for the daily kernels — full-CRSP scale on one device.

Firms are independent in every daily step (rolling windows and weekly sums
run along days WITHIN a firm column), so scale on one device is a host loop
over fixed-width firm strips: move a strip to the device, run the daily
steps on it, pull back the small (n_months, C) results. Peak device memory
is set by the strip, not by N. Two routes:

- ``daily_characteristics_compact_chunked`` (the main path's): strips of
  the compacted (CSR) daily layout. It assembles an (H, C) rectangle per
  strip on the host, only as tall as the strip's longest-lived firm.
- ``daily_characteristics_chunked`` (the dense route): strips of the dense
  (D, N) grid (``panel.daily.DailyPanel``), each (D, C) moved once. The
  strip width comes from a device-memory budget (``auto_firm_chunk``,
  ``FMRP_DAILY_BUDGET_BYTES``, else 60% of the card's memory); a grid that
  fits runs as one call.

With a ``mesh`` the compact route's strips split over the mesh's firm axis:
strips widen by the shard count (full blocks on every shard), and each
shard runs the strip functions on its (H, C/d) block on its device, so on
the card the rolling kernel launches once per shard per strip. Firms are
independent, so no collective runs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.ops.daily_compact import (
    daily_compact_strip,
    daily_compact_strip_contiguous,
)
from fm_returnprediction_tpu_torch.ops.daily_kernels import (
    rolling_vol_252_monthly,
    weekly_rolling_beta_monthly,
)

__all__ = [
    "auto_firm_chunk",
    "daily_characteristics_chunked",
    "daily_characteristics_compact_chunked",
]

# Peak live (D, C)-shaped arrays of the dense route's vol and beta steps
# (the compaction plan's int and bool arrays, the compacted returns, the
# rolling sums, the scatter-back, beta's masked logs and products before the
# weekly sums), counted in the input's dtype: the budget is a guardrail, not
# a tuned high-water mark. The plan's indices are int64, so a float32 grid
# peaks a little above it (1.04x at real size on the card, PERF.md).
_WORKSPACE_ARRAYS = 12


def _default_budget_bytes(device=None) -> int:
    """The dense route's device workspace budget: ``FMRP_DAILY_BUDGET_BYTES``
    when set, else 60% of the card's memory on a CUDA ``device`` (None
    means the card), else 4 GiB."""
    env = os.environ.get("FMRP_DAILY_BUDGET_BYTES")
    if env:
        return int(env)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory * 0.6)
    return 4 << 30


def auto_firm_chunk(
    n_days: int,
    n_firms: int,
    itemsize: int,
    budget_bytes: Optional[int] = None,
    device=None,
) -> Optional[int]:
    """Firm-strip width that keeps the dense route's working set under
    ``budget_bytes`` (default ``_default_budget_bytes(device)``), in
    multiples of 128 firms and at least 128, or None when the whole grid
    fits (one call)."""
    if budget_bytes is None:
        budget_bytes = _default_budget_bytes(device)
    per_firm = n_days * itemsize * _WORKSPACE_ARRAYS
    if per_firm * n_firms <= budget_bytes:
        return None
    chunk = int(budget_bytes // max(per_firm, 1))
    chunk = max((chunk // 128) * 128, 128)
    return min(chunk, n_firms)


def daily_characteristics_chunked(
    ret_d,
    mask_d,
    mkt_d,
    month_id,
    week_id,
    week_month_id,
    n_months: int,
    n_weeks: int,
    mkt_present=None,
    window: int = 252,
    min_periods: int = 100,
    window_weeks: int = 156,
    firm_chunk: Optional[int] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """vol-252 and weekly beta from the dense (D, N) grid over firm strips;
    returns numpy (n_months, N) pairs in ``ret_d``'s dtype.

    Inputs are host numpy: ``ret_d``/``mask_d`` (D, N), the per-day
    ``mkt_d``, ``month_id`` and ``week_id`` (any order; ids outside
    ``[0, n_weeks)`` drop the day from the weekly sums), and
    ``week_month_id`` (n_weeks,). The per-day vectors
    move to ``device`` (None means the card) once for all strips; each strip
    moves (D, C) once and runs ``rolling_vol_252_monthly`` (the rolling
    kernel on the card) and ``weekly_rolling_beta_monthly``.
    ``firm_chunk=None`` takes ``auto_firm_chunk``'s width (None: one call).
    Strips are an execution schedule only: every step is per firm column,
    so strips are not padded and give the single call's numbers.
    """
    device = resolve_device(device)
    ret_d = np.asarray(ret_d)
    mask_d = np.asarray(mask_d, dtype=bool)
    mkt_d = np.asarray(mkt_d, dtype=ret_d.dtype)
    mkt_present = np.isfinite(mkt_d) if mkt_present is None else np.asarray(mkt_present)
    d_days, n_firms = ret_d.shape

    if firm_chunk is None:
        firm_chunk = auto_firm_chunk(d_days, n_firms, ret_d.dtype.itemsize, device=device)

    def to_device(a: np.ndarray) -> torch.Tensor:
        # a read-only array (a memory map, a pandas-owned buffer) is copied,
        # not wrapped
        a = np.ascontiguousarray(a)
        return (torch.from_numpy(a) if a.flags.writeable else torch.tensor(a)).to(device)

    # per-day vectors, shared by every strip: moved once
    month_t = torch.as_tensor(np.asarray(month_id), dtype=torch.int64, device=device)
    week_t = torch.as_tensor(np.asarray(week_id), dtype=torch.int64, device=device)
    week_month_t = torch.as_tensor(np.asarray(week_month_id), dtype=torch.int64,
                                   device=device)
    mkt_t = to_device(mkt_d)
    mkt_present_t = torch.as_tensor(mkt_present, dtype=torch.bool, device=device)

    def run(cols: slice):
        ret_t = to_device(ret_d[:, cols])
        mask_t = to_device(mask_d[:, cols])
        vol = rolling_vol_252_monthly(ret_t, mask_t, month_t, n_months,
                                      window=window, min_periods=min_periods)
        beta = weekly_rolling_beta_monthly(ret_t, mask_t, mkt_t, week_t, n_weeks,
                                           week_month_t, n_months, window_weeks=window_weeks,
                                           mkt_present=mkt_present_t)
        return vol.cpu().numpy(), beta.cpu().numpy()

    if firm_chunk is None or firm_chunk >= n_firms:
        return run(slice(None))
    vol_out = np.empty((n_months, n_firms), dtype=ret_d.dtype)
    beta_out = np.empty((n_months, n_firms), dtype=ret_d.dtype)
    c = int(firm_chunk)
    for start in range(0, n_firms, c):
        cols = slice(start, min(start + c, n_firms))
        vol_out[:, cols], beta_out[:, cols] = run(cols)
    return vol_out, beta_out


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
    window: int = 252,
    min_periods: int = 100,
    window_weeks: int = 156,
    firm_chunk=None,
    height_bucket: int = 1024,
    mesh=None,
    axis_name: str = "firms",
    *,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """vol-252 and weekly beta from the compacted daily layout; returns
    numpy (n_months, N) pairs in the ORIGINAL firm order.

    Each strip's rectangle is only as tall as its longest-lived firm
    (rounded up to ``height_bucket``), so bytes moved track observed rows,
    not the dense (D, N) grid. Strips whose firms are all day-contiguous
    ship per-firm starts/counts instead of the position rectangle. With a
    1-D ``mesh`` of this process's devices the strips shard over its
    ``axis_name`` axis (module docstring) and ``device`` is not used;
    without one the strips run on ``device`` (None: the card). ``dtype``
    is the compute dtype (None: ``row_values``'). ``week_id`` may come in
    any order (``ops.daily_kernels.weekly_partial_sums``).
    """
    row_values = np.asarray(row_values)
    row_pos = np.asarray(row_pos)
    offsets = np.asarray(offsets)
    counts = np.diff(offsets)
    n_firms = len(counts)
    np_dtype = (row_values.dtype if dtype is None
                else torch.empty(0, dtype=dtype).numpy().dtype)
    if mesh is None:
        shard_devices = [resolve_device(device)]
    else:
        if mesh.axis_names != (axis_name,) or len(mesh.local_positions()) != mesh.size:
            raise ValueError(f"the daily strips shard over a 1-D '{axis_name}' mesh of this "
                             f"process's devices, got {mesh!r}")
        shard_devices = mesh.local_devices()
    n_shards = len(shard_devices)
    order, c = _strip_plan(counts, height_bucket, firm_chunk, n_shards)
    cw = c // n_shards

    # the per-day vectors, once per device (shards of one card share them)
    host_vectors = {
        "mkt_d": (np.asarray(mkt_d, dtype=np_dtype), None),
        "mkt_present": (np.asarray(mkt_present), torch.bool),
        "day_month_id": (np.asarray(day_month_id), torch.int64),
        "week_id": (np.asarray(week_id), torch.int64),
        "week_month_id": (np.asarray(week_month_id), torch.int64),
    }
    per_device = {}
    for d in shard_devices:
        if d not in per_device:
            per_device[d] = [torch.tensor(a, device=d, dtype=dt)
                             for a, dt in host_vectors.values()]
    kwargs = dict(n_days=int(n_days), n_weeks=int(n_weeks), n_months=int(n_months),
                  window=window, min_periods=min_periods, window_weeks=window_weeks)

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
