"""Prepared inputs at real CRSP scale, generated with numpy from a seed.

The port's entry point starts from the prepared inputs (a dense base panel
and compacted daily strips), so a run at the shape users run — 600 months,
22,000 permnos, ~77M firm-day rows — needs no raw files and no host ingest.
The content follows the repository's bench-scale universe: firms have
contiguous lifetimes (uniform starts, log-normal lengths of at least 24
months), daily returns load on a market factor with firm betas in
[0.3, 1.8] plus idiosyncratic noise and 0.5% missing returns, 35% of firms
list on the NYSE, and annual fundamentals are constant within each year.
It is smoke input, not a parity fixture: every column is finite where the
firm is alive, but no relational transform produced it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd
from pandas.tseries.offsets import MonthEnd

from fm_returnprediction_tpu_torch.panel.characteristics import BASE_COLUMNS
from fm_returnprediction_tpu_torch.panel.daily import CompactDaily
from fm_returnprediction_tpu_torch.panel.dense import DensePanel

__all__ = ["make_smoke_inputs"]


def _month_index_of(dates: pd.DatetimeIndex, months: np.ndarray) -> np.ndarray:
    """Month-end timestamps → indices into ``months``; unmatched → len."""
    months_i8 = np.asarray(pd.DatetimeIndex(months), dtype="datetime64[s]").astype(np.int64)
    dates_i8 = np.asarray(pd.DatetimeIndex(dates), dtype="datetime64[s]").astype(np.int64)
    pos = np.searchsorted(months_i8, dates_i8)
    pos_c = np.minimum(pos, len(months_i8) - 1)
    return np.where(months_i8[pos_c] == dates_i8, pos_c, len(months_i8)).astype(np.int32)


def make_smoke_inputs(
    n_firms: int = 22000,
    n_months: int = 600,
    seed: int = 20140131,
    start: str = "1964-01-31",
    frac_nyse: float = 0.35,
    dtype=np.float32,
) -> Tuple[DensePanel, CompactDaily]:
    """``(dense_base, compact_daily)`` with BASE_COLUMNS (incl. ``is_nyse``)
    over ``n_months`` × ``n_firms`` and the matching daily strips."""
    rng = np.random.default_rng(seed)
    months = pd.date_range(start, periods=n_months, freq="ME")
    days = pd.bdate_range(months[0] - MonthEnd(1) + pd.Timedelta(days=1),
                          months[-1])
    day_month = np.searchsorted(months.values, (days + MonthEnd(0)).values)
    month_lo = np.searchsorted(day_month, np.arange(n_months), side="left")
    month_hi = np.searchsorted(day_month, np.arange(n_months), side="right")
    mkt = rng.normal(3e-4, 0.008, len(days))

    # firm vocabulary and contiguous lifetimes
    ids = (10000 + np.arange(n_firms) * 2).astype(np.int64)
    min_life = min(24, max(n_months // 2, 1))
    m0 = rng.integers(0, max(n_months - min_life, 1), n_firms)
    life = np.clip(rng.lognormal(5.1, 0.8, n_firms).astype(np.int64), min_life, None)
    m1 = np.minimum(m0 + life, n_months - 1)
    betas = rng.uniform(0.3, 1.8, n_firms)
    idio = rng.uniform(0.01, 0.03, n_firms)
    base_prc = rng.uniform(5, 80, n_firms)
    base_shr = rng.integers(1_000, 50_000, n_firms).astype(np.float64)
    issue_rate = rng.uniform(0.0, 0.004, n_firms)
    nyse = rng.random(n_firms) < frac_nyse

    # daily rows, firm-major chronological
    d0 = month_lo[m0]
    counts = (month_hi[m1] - d0).astype(np.int64)
    offsets = np.zeros(n_firms + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    within = np.arange(offsets[-1], dtype=np.int64) - np.repeat(offsets[:-1], counts)
    day_idx = np.repeat(d0.astype(np.int64), counts) + within
    del within
    ret = np.repeat(betas, counts) * mkt[day_idx]
    ret += rng.standard_normal(len(day_idx)) * np.repeat(idio, counts)
    ret[rng.random(len(day_idx)) < 0.005] = np.nan
    pos_dtype = np.int16 if len(days) < np.iinfo(np.int16).max else np.int32

    epoch_days = np.asarray(days, dtype="datetime64[D]").astype(np.int64)
    monday_week = (epoch_days + 3) // 7   # 1970-01-05 was the first Monday
    week0 = monday_week.min()
    week_id = (monday_week - week0).astype(np.int32)
    n_weeks = int(week_id.max()) + 1
    mondays = pd.to_datetime((np.arange(n_weeks) + week0) * 7 - 3, unit="D")
    daily = CompactDaily(
        row_values=ret.astype(dtype),
        row_pos=day_idx.astype(pos_dtype),
        offsets=offsets,
        ids=ids,
        mkt=mkt.astype(dtype),
        mkt_present=np.ones(len(days), dtype=bool),
        days=np.asarray(days),
        day_month_id=day_month.astype(np.int32),
        week_id=week_id,
        n_weeks=n_weeks,
        week_month_id=_month_index_of(mondays + MonthEnd(0), months.values),
        n_months=n_months,
    )
    del ret, day_idx

    # monthly base panel
    t = np.arange(n_months)[:, None]
    mask = (t >= m0[None, :]) & (t <= m1[None, :])
    shape = (n_months, n_firms)
    years = np.arange(n_months) // 12
    n_years = int(years[-1]) + 1
    assets_y = rng.uniform(50, 5000, n_firms) * np.exp(
        rng.normal(0.08, 0.15, (n_years, n_firms)))
    earnings_y = assets_y * rng.normal(0.04, 0.05, (n_years, n_firms))
    prc = base_prc * np.exp(rng.normal(0.0, 0.15, shape))
    shrout = base_shr * np.exp((t - m0[None, :]) * np.log1p(issue_rate))
    cols = {
        "retx": rng.normal(0.008, 0.07, shape),
        "prc": prc,
        "shrout": shrout,
        "me": prc * shrout,
        "be": (assets_y * rng.uniform(0.2, 0.7, (n_years, n_firms)))[years],
        "accruals": (assets_y * rng.normal(0.0, 0.05, (n_years, n_firms)))[years],
        "depreciation": (assets_y * 0.04)[years],
        "earnings": earnings_y[years],
        "assets": assets_y[years],
        "sales": (assets_y * rng.uniform(0.4, 1.5, (n_years, n_firms)))[years],
        "total_debt": (assets_y * rng.uniform(0.0, 0.6, (n_years, n_firms)))[years],
        "dvc": (np.maximum(earnings_y, 0.0) * 0.25)[years],
        "is_nyse": np.broadcast_to(nyse.astype(np.float64), shape),
    }
    values = np.empty(shape + (len(BASE_COLUMNS),), dtype=dtype)
    for k, name in enumerate(BASE_COLUMNS):
        values[:, :, k] = np.where(mask, cols.pop(name), np.nan)
    panel = DensePanel(
        values=values,
        mask=mask,
        months=np.asarray(months.values, dtype="datetime64[ns]"),
        ids=ids,
        var_names=list(BASE_COLUMNS),
    )
    return panel, daily
