"""Prepared Lewellen inputs at CRSP scale, drawn on the device from a seed.

A frozen copy of the port's ``data/smoke_inputs.make_smoke_inputs``, kept
here so that the benchmark's traffic cannot change with the program. It
returns plain host arrays (no class of the program), which the traffic modules wrap
into the program's ``DensePanel`` and ``CompactDaily`` (the program's prepared
inputs live on the host) and the reference reads as they are.

Content, as in the original: firms live over contiguous months (log-normal
lengths of at least 24 months); daily returns load on a market factor with
firm betas in [0.3, 1.8] plus idiosyncratic noise and 0.5% missing returns;
35% of firms list on the NYSE; annual fundamentals are constant within each
year. Departures from the original:

- a third of the firms' starts fall before the first month, so the first
  cross-sections hold thousands of firms, as CRSP's do (uniform starts from
  the first month leave a few dozen firms in the early months, where
  regressions of 15 columns are all but exactly determined);
- shares outstanding move by a firm's issuance drift plus an issue or a
  buyback in about one month in ten (the original's constant drift makes
  Log Issues (-1,-12) and (-1,-36) exactly proportional, so Model 3's design
  is singular);
- every seed deals out the same firm layout (starts, lifetimes, 35% NYSE
  listings exactly) in its own order, so the amount of work does not move
  with the seed; the values are the seed's;
- the draws are made with ``torch.Generator`` on ``device`` in a few large
  calls, the monthly panel and the daily rows from two independent streams
  of the seed, so ``daily=False`` (the GHZ panel) builds the same monthly
  panel without drawing 77M daily returns. The card and the CPU draw
  different streams: a seed repeats its inputs on one kind of device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd
import torch
from pandas.tseries.offsets import MonthEnd

LAYOUT_SEED = 20140131
BASE_COLUMNS = [
    "retx", "prc", "shrout", "me", "be", "accruals", "depreciation",
    "earnings", "assets", "sales", "total_debt", "dvc", "is_nyse",
]


def _month_index_of(dates, months) -> np.ndarray:
    """Month-end timestamps → indices into ``months``; unmatched → len."""
    months_i8 = np.asarray(pd.DatetimeIndex(months), dtype="datetime64[s]").astype(np.int64)
    dates_i8 = np.asarray(pd.DatetimeIndex(dates), dtype="datetime64[s]").astype(np.int64)
    pos = np.searchsorted(months_i8, dates_i8)
    pos_c = np.minimum(pos, len(months_i8) - 1)
    return np.where(months_i8[pos_c] == dates_i8, pos_c, len(months_i8)).astype(np.int32)


def _generators(seed: int, device):
    """Two independent generators of the seed: the monthly panel's and the
    daily rows'."""
    out = []
    for child in np.random.SeedSequence(int(seed)).spawn(2):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1)))
        out.append(g)
    return out


def _monthly(g, n_firms: int, n_months: int, frac_nyse: float, device):
    f64 = dict(device=device, dtype=torch.float64)

    def unif(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, **f64)

    def norm(mu, sd, shape):
        return mu + sd * torch.randn(shape, generator=g, **f64)

    # the firms' starts and lifetimes, and the NYSE listings, are one fixed
    # layout that the seed deals out in its own order: every seed makes the
    # same number of firm-months and daily rows, so the work does not move
    # with the seed
    layout = torch.Generator(device=device)
    layout.manual_seed(LAYOUT_SEED)
    min_life = min(24, max(n_months // 2, 1))
    lead = n_months // 3
    m0 = torch.randint(-lead, max(n_months - min_life, 1), (n_firms,), generator=layout,
                       device=device)
    life = torch.exp(5.1 + 0.8 * torch.randn((n_firms,), generator=layout, device=device,
                                             dtype=torch.float64)).to(torch.int64)
    life = torch.maximum(life.clamp_min(min_life), min_life - m0.clamp_max(0))
    deal = torch.randperm(n_firms, generator=g, device=device)
    m0, life = m0[deal], life[deal]
    m1 = torch.clamp_max(m0 + life, n_months - 1)
    m0 = m0.clamp_min(0)
    base_prc = unif(5, 80, (n_firms,))
    base_shr = torch.randint(1_000, 50_000, (n_firms,), generator=g, device=device).double()
    issue_rate = unif(0.0, 0.004, (n_firms,))
    listed = torch.arange(n_firms, device=device) < round(frac_nyse * n_firms)
    nyse = listed[torch.randperm(n_firms, generator=g, device=device)]

    t = torch.arange(n_months, device=device)[:, None]
    mask = (t >= m0[None, :]) & (t <= m1[None, :])
    shape = (n_months, n_firms)
    years = torch.arange(n_months, device=device) // 12
    n_years = int(years[-1]) + 1
    assets_y = unif(50, 5000, (n_firms,)) * torch.exp(norm(0.08, 0.15, (n_years, n_firms)))
    earnings_y = assets_y * norm(0.04, 0.05, (n_years, n_firms))
    prc = base_prc * torch.exp(norm(0.0, 0.15, shape))
    step = torch.log1p(issue_rate) + norm(0.0, 0.03, shape) * (
        torch.rand(shape, generator=g, device=device) < 0.1)
    cum = torch.cumsum(step, dim=0)
    shrout = base_shr * torch.exp(cum - cum[m0, torch.arange(n_firms, device=device)][None, :])
    cols = {
        "retx": norm(0.008, 0.07, shape),
        "prc": prc,
        "shrout": shrout,
        "me": prc * shrout,
        "be": (assets_y * unif(0.2, 0.7, (n_years, n_firms)))[years],
        "accruals": (assets_y * norm(0.0, 0.05, (n_years, n_firms)))[years],
        "depreciation": (assets_y * 0.04)[years],
        "earnings": earnings_y[years],
        "assets": assets_y[years],
        "sales": (assets_y * unif(0.4, 1.5, (n_years, n_firms)))[years],
        "total_debt": (assets_y * unif(0.0, 0.6, (n_years, n_firms)))[years],
        "dvc": (torch.clamp_min(earnings_y, 0.0) * 0.25)[years],
        "is_nyse": nyse.double()[None, :].expand(shape),
    }
    values = torch.stack([torch.where(mask, cols.pop(name), torch.nan).float()
                          for name in BASE_COLUMNS], dim=-1)
    return m0, m1, mask, values


def make_lewellen_inputs(seed: int, n_firms: int = 22000, n_months: int = 600,
                         start: str = "1964-01-31", frac_nyse: float = 0.35,
                         daily: bool = True, device="cpu") -> Dict[str, object]:
    """The monthly base panel over BASE_COLUMNS (``values`` (T, N, K)
    float32, NaN where the firm is not alive; ``mask`` (T, N); ``months``;
    ``ids``; ``var_names``) and, with ``daily``, the firm-major daily rows
    (``row_values``, ``row_pos``, ``offsets``) with the calendar
    (``mkt``, ``days``, ``day_month_id``, ``week_id``, ``n_weeks``,
    ``week_month_id``); host arrays, drawn on ``device``."""
    g_month, g_day = _generators(seed, device)
    months = pd.date_range(start, periods=n_months, freq="ME")
    m0, m1, mask, values = _monthly(g_month, n_firms, n_months, frac_nyse, device)
    out: Dict[str, object] = {
        "values": values.cpu().numpy(), "mask": mask.cpu().numpy(),
        "months": np.asarray(months.values, dtype="datetime64[ns]"),
        "ids": (10000 + np.arange(n_firms) * 2).astype(np.int64),
        "var_names": list(BASE_COLUMNS),
    }
    del values, mask
    if not daily:
        return out

    days = pd.bdate_range(months[0] - MonthEnd(1) + pd.Timedelta(days=1), months[-1])
    day_month = np.searchsorted(months.values, (days + MonthEnd(0)).values)
    month_lo = torch.as_tensor(np.searchsorted(day_month, np.arange(n_months), side="left"),
                               device=device)
    month_hi = torch.as_tensor(np.searchsorted(day_month, np.arange(n_months), side="right"),
                               device=device)
    mkt = 3e-4 + 0.008 * torch.randn(len(days), generator=g_day, device=device,
                                     dtype=torch.float64)
    betas = 0.3 + 1.5 * torch.rand(n_firms, generator=g_day, device=device)
    idio = 0.01 + 0.02 * torch.rand(n_firms, generator=g_day, device=device)

    d0 = month_lo[m0]
    counts = month_hi[m1] - d0
    offsets = torch.zeros(n_firms + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(counts, dim=0)
    n_rows = int(offsets[-1])
    firm = torch.repeat_interleave(torch.arange(n_firms, device=device), counts)
    day_idx = d0[firm] + torch.arange(n_rows, device=device) - offsets[:-1][firm]
    ret = torch.randn(n_rows, generator=g_day, device=device) * idio[firm]
    ret += betas[firm] * mkt.float()[day_idx]
    ret[torch.rand(n_rows, generator=g_day, device=device) < 0.005] = torch.nan
    del firm
    pos_dtype = torch.int16 if len(days) < np.iinfo(np.int16).max else torch.int32

    epoch_days = np.asarray(days, dtype="datetime64[D]").astype(np.int64)
    monday_week = (epoch_days + 3) // 7   # 1970-01-05 was the first Monday
    week0 = monday_week.min()
    week_id = (monday_week - week0).astype(np.int32)
    n_weeks = int(week_id.max()) + 1
    mondays = pd.to_datetime((np.arange(n_weeks) + week0) * 7 - 3, unit="D")
    out.update(
        row_values=ret.cpu().numpy(), row_pos=day_idx.to(pos_dtype).cpu().numpy(),
        offsets=offsets.cpu().numpy(), mkt=mkt.float().cpu().numpy(),
        mkt_present=np.ones(len(days), dtype=bool),
        days=np.asarray(days), day_month_id=day_month.astype(np.int32),
        week_id=week_id, n_weeks=n_weeks,
        week_month_id=_month_index_of(mondays + MonthEnd(0), months.values),
        n_months=n_months,
    )
    return out
