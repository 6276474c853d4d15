"""Compustat fundamental transforms and the CRSP⊗Compustat merge (host side).

Behavioral port of the reference's ``src/transform_compustat.py``:

- ``add_report_date``: fundamentals become known 4 months after fiscal
  year-end (``:42-55``);
- ``calc_book_equity``: preferred-stock fallback chain and
  ``be = seq + txditc − ps`` kept only when positive (``:58-98``);
- ``expand_compustat_annual_to_monthly``: annual rows forward-filled onto a
  month-end grid from each firm's first report date to its last + 12 months,
  capped at the global max (``:101-181``). Vectorized here with a grid
  construction + ``merge_asof`` instead of a per-gvkey ``groupby.apply``
  (identical output, orders of magnitude faster on the full panel; duplicate
  report dates per gvkey keep the last row, where the reference's reindex
  would raise);
- ``merge_CRSP_and_Compustat``: CCM link-window join then inner join to CRSP
  on (permno, jdate) (``:184-226``).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

__all__ = [
    "add_report_date",
    "calc_book_equity",
    "expand_compustat_annual_to_monthly",
    "merge_CRSP_and_Compustat",
]


def add_report_date(comp: pd.DataFrame) -> pd.DataFrame:
    """``report_date = datadate + 4 months`` (reference ``:42-55``)."""
    if not pd.api.types.is_datetime64_any_dtype(comp["datadate"]):
        comp["datadate"] = pd.to_datetime(comp["datadate"])
    comp["report_date"] = comp["datadate"] + pd.DateOffset(months=4)
    return comp


def calc_book_equity(comp: pd.DataFrame) -> pd.DataFrame:
    """Book equity with the preferred-stock fallback pstkrv→pstkl→pstk→0;
    ``be = seq + txditc − ps`` kept only where positive (reference ``:58-98``)."""
    comp = comp.assign(ps=lambda x: x["pstkrv"].fillna(x["pstkl"]))
    comp["ps"] = comp["ps"].fillna(comp["pstk"]).fillna(0)
    comp["txditc"] = comp["txditc"].fillna(0)
    comp["be"] = comp["seq"] + comp["txditc"] - comp["ps"]
    comp["be"] = comp["be"].where(comp["be"] > 0, np.nan)
    comp = comp.dropna(subset=["be"])
    return comp.drop(columns=["ps", "pstk", "pstkrv", "pstkl"], errors="ignore")


def expand_compustat_annual_to_monthly(
    comp_annual: pd.DataFrame,
    id_col: str = "gvkey",
    report_date_col: str = "report_date",
) -> pd.DataFrame:
    """Expand annual fundamentals to a monthly series per firm.

    For each firm: month-end grid from its first report date to
    ``min(global max report date, last report date + 12 months)``, with each
    grid month carrying the latest report whose date is ≤ the grid date
    (forward fill). Output columns: ``<id_col>``, ``fund_date`` (the grid
    month-end), and all fundamental columns (``fyear`` dropped).
    """
    df = comp_annual.drop(columns=["fyear"], errors="ignore").copy()
    df["fund_date"] = df[report_date_col]
    df = df.sort_values([id_col, "fund_date"], kind="stable")
    df = df.drop_duplicates(subset=[id_col, "fund_date"], keep="last")

    bounds = df.groupby(id_col)["fund_date"].agg(["min", "max"])
    global_max = df["fund_date"].max()
    end = np.minimum(
        (bounds["max"] + pd.DateOffset(months=12)).to_numpy(),
        np.datetime64(global_max),
    )
    # Month-end grid per firm: month offsets from each firm's start month.
    # A month is included only if its month-END is <= the cap date, matching
    # pd.date_range(start, end, freq='ME') semantics in the reference.
    start_period = bounds["min"].dt.to_period("M")
    end_index = pd.DatetimeIndex(end)
    end_period = pd.PeriodIndex(end_index, freq="M")
    end_is_month_end = end_index == end_period.to_timestamp(how="end").normalize()
    month_diff = (end_period.year - start_period.dt.year.to_numpy()) * 12 + (
        end_period.month - start_period.dt.month.to_numpy()
    )
    n_months = month_diff + np.where(end_is_month_end, 1, 0)
    # A firm whose grid is empty (single mid-month report in the global-max
    # month: date_range(start, cap, freq='ME') has no month-end <= cap) is
    # absent from the reference's expansion — drop it, don't clamp to 1.
    keep = n_months > 0
    bounds, n_months = bounds[keep], n_months[keep]
    start_period = start_period[keep]

    firm_ids = np.repeat(bounds.index.to_numpy(), n_months)
    month_offsets = np.concatenate([np.arange(n) for n in n_months])
    start_repeat = np.repeat(start_period.to_numpy(), n_months)
    grid_dates = (
        pd.PeriodIndex(start_repeat, freq="M") + month_offsets
    ).to_timestamp(how="end").normalize()

    grid = pd.DataFrame({id_col: firm_ids, "fund_date": grid_dates})
    # reference semantics: the first grid point is the first report date
    # itself (not its month-end) when that date is not a month-end — the
    # pandas reindex starts the range AT min fund_date with freq='ME', so the
    # grid is pure month-ends and a mid-month first report only appears via
    # ffill at the first month-end >= it. Grid months before the first report
    # (same month, earlier day) must not survive the asof merge:
    expanded = pd.merge_asof(
        grid.sort_values("fund_date", kind="stable"),
        df.sort_values("fund_date", kind="stable").rename(
            columns={"fund_date": "report_fund_date"}
        ),
        left_on="fund_date",
        right_on="report_fund_date",
        by=id_col,
        direction="backward",
    )
    expanded = expanded.dropna(subset=["report_fund_date"])
    expanded = expanded.drop(columns=["report_fund_date"])
    return expanded.sort_values([id_col, "fund_date"], kind="stable").reset_index(
        drop=True
    )


def merge_CRSP_and_Compustat(
    crsp: pd.DataFrame, comp: pd.DataFrame, ccm: pd.DataFrame
) -> pd.DataFrame:
    """CCM link-window join: fundamentals → link table on gvkey, restricted to
    ``linkdt ≤ jdate ≤ linkenddt`` (missing linkenddt = still valid → today),
    then inner join to CRSP on (permno, jdate) (reference ``:184-226``)."""
    ccm = ccm.copy()
    ccm["linkenddt"] = ccm["linkenddt"].fillna(pd.to_datetime("today"))
    comp = comp.rename(columns={"fund_date": "jdate"})
    linked = pd.merge(comp, ccm, how="left", on=["gvkey"])
    linked = linked[
        (linked["jdate"] >= linked["linkdt"]) & (linked["jdate"] <= linked["linkenddt"])
    ]
    linked = linked[["permno"] + list(comp.columns)]
    return pd.merge(crsp, linked, how="inner", on=["permno", "jdate"])
