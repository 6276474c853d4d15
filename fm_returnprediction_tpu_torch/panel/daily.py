"""Daily data on the host (numpy), in two layouts.

- ``CompactDaily`` (``build_compact_daily``): each firm's observed rows in
  chronological order, flattened firm-major, with int day positions into
  the shared trading-day vocabulary. It never builds the dense (D, N)
  grid; the main path's daily strips (``ops.daily_chunked.
  daily_characteristics_compact_chunked``) read it.
- ``DailyPanel`` (``build_daily_panel``): the dense (D, N) grid of daily
  returns and its mask, the input of the dense route
  (``ops.daily_chunked.daily_characteristics_chunked``), which runs the
  daily kernels on the whole grid in firm strips under a device-memory
  budget.

Both carry the per-day calendar vectors the daily kernels need: month
index of each day (out-of-vocabulary months map to the trash segment
``n_months``) and the Monday-lattice week index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd
from pandas.tseries.offsets import MonthEnd

from fm_returnprediction_tpu_torch.panel.dense import long_to_dense

__all__ = ["DailyPanel", "CompactDaily", "build_daily_panel", "build_compact_daily",
           "build_compact_daily_arrays", "month_index_of"]


def month_index_of(dates: pd.DatetimeIndex, months: np.ndarray) -> np.ndarray:
    """Map month-end timestamps to indices in the monthly vocabulary
    (``months``, sorted datetime64); unmatched dates map to ``len(months)``."""
    # Unit-robust: pandas 3 frames may carry datetime64[us]/[s]/[ns]; compare
    # everything at second resolution.
    months_i8 = np.asarray(pd.DatetimeIndex(months), dtype="datetime64[s]").astype(np.int64)
    dates_i8 = np.asarray(pd.DatetimeIndex(dates), dtype="datetime64[s]").astype(np.int64)
    pos = np.searchsorted(months_i8, dates_i8)
    pos_clipped = np.minimum(pos, len(months_i8) - 1)
    hit = months_i8[pos_clipped] == dates_i8
    return np.where(hit, pos_clipped, len(months_i8)).astype(np.int32)


@dataclasses.dataclass
class DailyPanel:
    """Dense daily data aligned to a monthly panel's vocabularies."""

    ret: np.ndarray            # (D, N) daily retx
    mask: np.ndarray           # (D, N) firm-day present
    mkt: np.ndarray            # (D,) market return (vwretx), NaN if absent/null
    mkt_present: np.ndarray    # (D,) bool, index table has a row for the day
    days: np.ndarray           # (D,) datetime64
    ids: np.ndarray            # (N,) permnos
    day_month_id: np.ndarray   # (D,) month index into monthly vocab (trash=M)
    week_id: np.ndarray        # (D,) Monday-lattice week index
    n_weeks: int
    week_month_id: np.ndarray  # (n_weeks,) month index of each week's Monday
    n_months: int


@dataclasses.dataclass
class CompactDaily:
    """Daily data in per-firm compacted layout; the payload the chunked
    strip loop (``ops.daily_chunked``) slices into strips."""

    row_values: np.ndarray     # (R,) retx rows, firm-major chronological
    row_pos: np.ndarray        # (R,) day index; int16 when n_days < 32768
    offsets: np.ndarray        # (N+1,) int64 firm row ranges
    ids: np.ndarray            # (N,) permnos (sorted, same vocab as dense)
    mkt: np.ndarray            # (D,) market return (vwretx)
    mkt_present: np.ndarray    # (D,) bool, index table has the day
    days: np.ndarray           # (D,) datetime64 trading-day vocabulary
    day_month_id: np.ndarray   # (D,) month index (trash=n_months)
    week_id: np.ndarray        # (D,) Monday-lattice week index
    n_weeks: int
    week_month_id: np.ndarray  # (n_weeks,) month index of each week's Monday
    n_months: int

    @property
    def n_days(self) -> int:
        return len(self.days)

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)


def _daily_calendar(crsp_index_d: pd.DataFrame, days: pd.DatetimeIndex,
                    months: np.ndarray, dtype):
    """Shared per-day vectors: market series aligned to the trading-day
    vocabulary, month ids, and the Monday week lattice."""
    idx = crsp_index_d.drop_duplicates(subset=["caldt"], keep="last").set_index("caldt")
    mkt = idx["vwretx"].reindex(days).to_numpy(dtype=dtype)
    mkt_present = np.asarray(days.isin(idx.index))

    day_month_id = month_index_of(days + MonthEnd(0), months)

    # Monday lattice: numpy day-of-epoch arithmetic (1970-01-01 was a Thursday,
    # so epoch day 4 was the first Monday; (d + 3) // 7 indexes Monday weeks).
    epoch_days = np.asarray(days, dtype="datetime64[D]").astype(np.int64)
    monday_week = (epoch_days + 3) // 7
    week0 = monday_week.min()
    week_id = (monday_week - week0).astype(np.int32)
    n_weeks = int(week_id.max()) + 1

    week_mondays = pd.to_datetime((np.arange(n_weeks) + week0) * 7 - 3, unit="D")
    week_month_id = month_index_of(week_mondays + MonthEnd(0), months)
    return mkt, mkt_present, day_month_id, week_id, n_weeks, week_month_id


def build_compact_daily(
    crsp_d: pd.DataFrame,
    crsp_index_d: pd.DataFrame,
    months: np.ndarray,
    dtype=np.float64,
) -> CompactDaily:
    """Pack daily CRSP rows into the compacted per-firm layout WITHOUT ever
    materializing the dense (D, N) grid — O(R) host memory for R observed
    rows (the reference's daily volume note, SURVEY §3.5).

    Host path is numpy end-to-end, with no pandas sort of the daily frame:
    the common case (cache written firm-major chronological) needs only an
    O(R) sortedness check, flag-based keep-last dedup and factorization,
    and a direct-addressed day vocabulary. ``dtype`` is a numpy dtype."""
    date_raw = crsp_d["dlycaldt"].to_numpy()
    return build_compact_daily_arrays(
        crsp_d["permno"].to_numpy(),
        date_raw,
        crsp_d["retx"].to_numpy(dtype=dtype),
        crsp_index_d,
        months,
        dtype=dtype,
    )


def build_compact_daily_arrays(
    permno: np.ndarray,
    date_raw: np.ndarray,
    retx: np.ndarray,
    crsp_index_d: pd.DataFrame,
    months: np.ndarray,
    dtype=np.float64,
) -> CompactDaily:
    """The array-core of :func:`build_compact_daily`: the same compaction
    from bare ``(permno, date, retx)`` columns."""
    # int64 view in the input's OWN datetime unit: both sides of every
    # comparison below come from this same array, so no [ns]->[s] astype
    # pass over the daily rows is needed.
    # Foreign caches (csv, parquet date32) load as object dtype — coerce
    # those the slow way first.
    if date_raw.dtype.kind != "M":
        # tz-aware columns stay object through a bare DatetimeIndex round
        # trip — force a concrete naive unit (UTC instants), as the old
        # pandas path did
        date_raw = np.asarray(
            pd.DatetimeIndex(date_raw), dtype="datetime64[s]"
        )
    date_i8 = date_raw.view(np.int64)
    retx = np.asarray(retx, dtype=dtype)

    if len(permno):
        in_order = (permno[:-1] < permno[1:]) | (
            (permno[:-1] == permno[1:]) & (date_i8[:-1] <= date_i8[1:])
        )
        if not in_order.all():
            order = np.lexsort((date_i8, permno))
            permno, date_i8, retx = permno[order], date_i8[order], retx[order]
        # keep-last dedup, matching long_to_dense's documented semantics so
        # the compact and dense/mesh paths agree on duplicated rows (lexsort
        # is stable, so the last occurrence stays last)
        dup = (permno[:-1] == permno[1:]) & (date_i8[:-1] == date_i8[1:])
        if dup.any():
            keep = np.ones(len(permno), dtype=bool)
            keep[:-1][dup] = False
            permno, date_i8, retx = permno[keep], date_i8[keep], retx[keep]

    # factorize the (sorted) firm axis in O(R)
    change = np.empty(len(permno), dtype=bool)
    if len(permno):
        change[0] = True
        np.not_equal(permno[1:], permno[:-1], out=change[1:])
    ids = permno[change]
    counts = np.diff(np.append(np.flatnonzero(change), len(permno)))

    # day vocabulary + positions. Fast path: CRSP trading dates are
    # day-aligned timestamps, so (date - min) // day_step direct-addresses a
    # tiny calendar-span table — one scatter builds the vocabulary and one
    # gather assigns positions (far cheaper than the hash
    # factorize + remap on one core). Misaligned timestamps or absurd spans
    # fall back to the general hash path with identical semantics
    # (distinct raw timestamps stay distinct vocabulary entries).
    _DAY_STEPS = {"D": 1, "s": 86_400, "ms": 86_400_000,
                  "us": 86_400_000_000, "ns": 86_400_000_000_000}
    step = _DAY_STEPS.get(np.datetime_data(date_raw.dtype)[0])
    days_i8 = None
    if step is not None and len(date_i8):
        dmin = int(date_i8.min())
        span = (int(date_i8.max()) - dmin) // step + 1
        aligned = dmin % step == 0 and span <= 1_000_000
        if aligned and step > 1:
            aligned = bool((date_i8 % step == 0).all())
        if aligned:
            day_idx = (date_i8 - dmin) // step
            present = np.zeros(span, dtype=bool)
            present[day_idx] = True
            vocab = np.flatnonzero(present)
            remap_t = np.zeros(span, dtype=np.int32)
            remap_t[vocab] = np.arange(len(vocab), dtype=np.int32)
            pos = remap_t[day_idx]
            days_i8 = vocab * step + dmin
    if days_i8 is None:
        codes, days_appear = pd.factorize(date_i8, sort=False)
        day_order = np.argsort(days_appear)
        days_i8 = days_appear[day_order]
        remap = np.empty_like(day_order)
        remap[day_order] = np.arange(len(day_order))
        pos = remap[codes]
    days_idx = pd.DatetimeIndex(np.asarray(days_i8).view(date_raw.dtype))
    n_days = len(days_idx)
    pos_dtype = np.int16 if n_days < np.iinfo(np.int16).max else np.int32

    offsets = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    mkt, mkt_present, day_month_id, week_id, n_weeks, week_month_id = _daily_calendar(
        crsp_index_d, days_idx, months, dtype
    )
    return CompactDaily(
        row_values=retx,
        row_pos=pos.astype(pos_dtype),
        offsets=offsets,
        ids=ids,
        mkt=mkt,
        mkt_present=mkt_present,
        days=np.asarray(days_idx),
        day_month_id=day_month_id,
        week_id=week_id,
        n_weeks=n_weeks,
        week_month_id=week_month_id,
        n_months=len(months),
    )


def build_daily_panel(
    crsp_d: pd.DataFrame,
    crsp_index_d: pd.DataFrame,
    months: np.ndarray,
    dtype=np.float64,
) -> DailyPanel:
    """Pack daily CRSP + index data into dense arrays aligned to ``months``.

    ``crsp_d`` needs [permno, dlycaldt, retx]; ``crsp_index_d`` needs
    [caldt, vwretx]. The market series is aligned to the observed
    trading-day vocabulary of ``crsp_d``: days the index lacks become NaN
    and ``mkt_present`` False, so beta drops them as the reference's inner
    join does. ``dtype`` is a numpy dtype. The (D, N) grid is host memory,
    ``D · N`` values and as many mask bytes.
    """
    dense = long_to_dense(crsp_d, "dlycaldt", "permno", ["retx"], dtype=dtype)
    days = pd.DatetimeIndex(dense.months)
    mkt, mkt_present, day_month_id, week_id, n_weeks, week_month_id = _daily_calendar(
        crsp_index_d, days, months, dtype
    )
    return DailyPanel(
        ret=dense.var("retx"),
        mask=dense.mask,
        mkt=mkt,
        mkt_present=mkt_present,
        days=dense.months,
        ids=dense.ids,
        day_month_id=day_month_id,
        week_id=week_id,
        n_weeks=n_weeks,
        week_month_id=week_month_id,
        n_months=len(months),
    )
