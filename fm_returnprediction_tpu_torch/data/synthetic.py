"""Deterministic synthetic CRSP/Compustat-shaped data — the fake-WRDS backend.

The reference has no test fixtures or fake backend; offline work relies on a
previously-populated parquet cache (SURVEY §4). This module generates small,
seeded DataFrames with the exact schemas the WRDS pullers produce
(``src/pull_crsp.py:217-235``, ``src/pull_compustat.py:168-219,312-321``), so
the full pipeline runs hermetically: multiple permnos per permco (exercises
ME aggregation), non-NYSE/ADR/non-common rows (exercises universe filters),
listing gaps, fiscal years ending both Dec 31 and Jun 30 (exercises the
4-month report lag and monthly expansion), link windows with gaps, and a
daily return history aligned with a market index (exercises the beta and
volatility kernels).

``write_synthetic_cache`` persists everything under the same file names the
pipeline loads (``CRSP_stock_d/m.parquet`` etc.,
``src/calc_Lewellen_2014.py:1236-1240``).

The generator is a per-row loop drawing from ONE ``default_rng`` in a fixed
order, the reference package's loop line for line: a config gives the same
frames in both packages. Do not vectorise it — another draw order is
another universe.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import pandas as pd
from pandas.tseries.offsets import MonthEnd

from fm_returnprediction_tpu_torch.utils.cache import save_cache_data

__all__ = ["FILE_NAMES", "SyntheticConfig", "generate_synthetic_wrds", "write_synthetic_cache"]

# Canonical cache file names (reference ``src/calc_Lewellen_2014.py:1236-1240``)
# — the single definition shared by the pipeline loader and both synthetic
# backends.
FILE_NAMES = {
    "crsp_m": "CRSP_stock_m.parquet",
    "crsp_d": "CRSP_stock_d.parquet",
    "crsp_index_d": "CRSP_index_d.parquet",
    "comp": "Compustat_fund.parquet",
    "ccm": "CRSP_Comp_Link_Table.parquet",
}


class SyntheticConfig:
    """Knobs for the synthetic universe (kept tiny for CI, scalable for bench)."""

    def __init__(
        self,
        n_firms: int = 40,
        n_months: int = 72,
        start: str = "1964-01-31",
        seed: int = 20140131,
        frac_nyse: float = 0.4,
        frac_noncommon: float = 0.1,
        frac_multishare: float = 0.1,
    ) -> None:
        self.n_firms = n_firms
        self.n_months = n_months
        self.start = start
        self.seed = seed
        self.frac_nyse = frac_nyse
        self.frac_noncommon = frac_noncommon
        self.frac_multishare = frac_multishare


def _trading_days(months: pd.DatetimeIndex) -> pd.DatetimeIndex:
    start = months[0] - MonthEnd(1) + pd.Timedelta(days=1)
    days = pd.bdate_range(start, months[-1])
    return days


def generate_synthetic_wrds(cfg: SyntheticConfig | None = None) -> Dict[str, pd.DataFrame]:
    """Generate the five datasets the pipeline consumes.

    Returns dict with keys ``crsp_m``, ``crsp_d``, ``crsp_index_d``, ``comp``,
    ``ccm`` (schemas matching the reference pullers' SQL output).
    """
    cfg = cfg or SyntheticConfig()
    rng = np.random.default_rng(cfg.seed)
    months = pd.date_range(cfg.start, periods=cfg.n_months, freq="ME")
    days = _trading_days(months)
    day_month_end = days + MonthEnd(0)

    # --- market index (daily) -------------------------------------------
    mkt_ret = rng.normal(3e-4, 0.008, len(days))
    crsp_index_d = pd.DataFrame(
        {
            "caldt": days,
            "vwretd": mkt_ret + 1e-4,
            "vwretx": mkt_ret,
            "ewretd": mkt_ret * 1.1,
            "ewretx": mkt_ret * 1.1,
            "sprtrn": mkt_ret * 0.95,
        }
    )

    # --- firms -----------------------------------------------------------
    monthly_rows, daily_rows, comp_rows, link_rows = [], [], [], []
    for firm in range(cfg.n_firms):
        permco = 5000 + firm
        permno = 10000 + firm * 2
        gvkey = f"{100000 + firm}"
        is_nyse = rng.random() < cfg.frac_nyse
        exch = "N" if is_nyse else ("Q" if rng.random() < 0.7 else "A")
        common = rng.random() > cfg.frac_noncommon

        # listing window (firms enter/exit)
        m0 = int(rng.integers(0, max(cfg.n_months // 4, 1)))
        m1 = int(rng.integers(3 * cfg.n_months // 4, cfg.n_months))

        beta_true = rng.uniform(0.3, 1.8)
        idio = rng.uniform(0.01, 0.03)
        price = float(rng.uniform(5, 80))
        shrout = float(rng.integers(1_000, 50_000))

        firm_days = days[(day_month_end >= months[m0]) & (day_month_end <= months[m1])]
        firm_mkt = mkt_ret[
            (day_month_end >= months[m0]) & (day_month_end <= months[m1])
        ]
        dly_ret = beta_true * firm_mkt + rng.normal(0, idio, len(firm_days))
        # sprinkle missing daily returns (rows exist, retx null — CRSP has
        # these; they must poison beta windows but not break price paths)
        nan_days = rng.random(len(firm_days)) < 0.01
        dly_ret_obs = np.where(nan_days, np.nan, dly_ret)

        shared = dict(
            permco=permco,
            issuertype="CORP" if common else "ABS",
            securitytype="EQTY",
            securitysubtype="COM" if common else "ADR",
            sharetype="NS",
            usincflg="Y" if common else "N",
            primaryexch=exch,
            conditionaltype="RW",
            tradingstatusflg="A",
        )

        # daily rows
        prices = price * np.cumprod(1 + dly_ret)
        for d, r, p in zip(firm_days, dly_ret_obs, prices):
            daily_rows.append(
                dict(
                    permno=permno,
                    dlycaldt=d,
                    totret=r + 2e-5,
                    retx=r,
                    prc=p,
                    shrout=shrout,
                    **shared,
                )
            )

        # monthly rows aggregated from daily; firm-specific share issuance
        # with occasional jumps so cross-sections of issuance are non-degenerate
        fd = pd.DataFrame({"d": firm_days, "r": dly_ret, "p": prices})
        fd["m"] = fd["d"] + MonthEnd(0)
        grouped = fd.groupby("m")
        issue_rate = float(rng.uniform(0.0, 0.005))
        # monthly share volume for the opt-in turnover characteristic:
        # per-firm turnover level ~ the published 0.08/month scale, with
        # lognormal month-to-month variation (vol is in shares, shrout in
        # thousands — the CRSP unit convention turnover = vol/(shrout·1e3))
        turn_level = float(rng.uniform(0.02, 0.20))
        sh = shrout
        for m, grp in grouped:
            mret = float(np.prod(1 + grp["r"].to_numpy()) - 1)
            sh = sh * (1 + issue_rate)
            if rng.random() < 0.03:
                sh *= float(rng.uniform(1.05, 1.3))  # seasoned offering
            monthly_rows.append(
                dict(
                    permno=permno,
                    mthcaldt=m,
                    totret=mret + 2e-4,
                    retx=mret,
                    prc=float(grp["p"].iloc[-1]),
                    shrout=sh,
                    vol=turn_level * sh * 1000.0 * float(rng.lognormal(0, 0.4)),
                    **shared,
                )
            )
        # occasional second share class (same permco) to exercise ME dedup
        if rng.random() < cfg.frac_multishare:
            for m, grp in grouped:
                monthly_rows.append(
                    dict(
                        permno=permno + 1,
                        mthcaldt=m,
                        totret=float(rng.normal(0.01, 0.05)),
                        retx=float(rng.normal(0.01, 0.05)),
                        prc=float(grp["p"].iloc[-1] * 0.5),
                        shrout=shrout * 0.2,
                        vol=turn_level * shrout * 200.0,
                        **shared,
                    )
                )

        # --- Compustat annual fundamentals ------------------------------
        fy_end_month = 12 if rng.random() < 0.8 else 6
        assets = float(rng.uniform(50, 5000))
        first_year = months[m0].year - 1
        last_year = months[m1].year
        for year in range(first_year, last_year + 1):
            datadate = pd.Timestamp(year=year, month=fy_end_month, day=1) + MonthEnd(0)
            growth = float(rng.normal(0.08, 0.15))
            assets *= 1 + growth
            sales = assets * float(rng.uniform(0.4, 1.5))
            earnings = assets * float(rng.normal(0.04, 0.05))
            comp_rows.append(
                dict(
                    gvkey=gvkey,
                    datadate=datadate,
                    fyear=year,
                    sales=sales,
                    earnings=earnings,
                    assets=assets,
                    accruals=float(rng.normal(0, 0.05)) * assets,
                    non_cash_current_assets=assets * 0.3,
                    lct=assets * 0.2,
                    total_debt=assets * float(rng.uniform(0.0, 0.6)),
                    depreciation=assets * 0.04,
                    dvpd=earnings * 0.3,
                    dvc=max(earnings, 0.0) * 0.25,
                    dvt=earnings * 0.3,
                    pstk=np.nan if rng.random() < 0.5 else assets * 0.01,
                    pstkl=np.nan if rng.random() < 0.5 else assets * 0.012,
                    pstkrv=np.nan if rng.random() < 0.5 else assets * 0.011,
                    txditc=np.nan if rng.random() < 0.3 else assets * 0.02,
                    seq=assets * float(rng.uniform(0.2, 0.7)),
                )
            )

        # --- CCM link ----------------------------------------------------
        link_start = months[m0] - MonthEnd(12)
        link_end = months[m1] if rng.random() < 0.8 else pd.NaT  # open link
        link_rows.append(
            dict(
                gvkey=gvkey,
                permno=permno,
                linktype="LU",
                linkprim="P",
                linkdt=link_start,
                linkenddt=link_end,
            )
        )

    crsp_m = pd.DataFrame(monthly_rows)
    crsp_m["jdate"] = crsp_m["mthcaldt"] + MonthEnd(0)
    crsp_d = pd.DataFrame(daily_rows)
    crsp_d["jdate"] = crsp_d["dlycaldt"] + MonthEnd(0)

    return {
        "crsp_m": crsp_m,
        "crsp_d": crsp_d,
        "crsp_index_d": crsp_index_d,
        "comp": pd.DataFrame(comp_rows),
        "ccm": pd.DataFrame(link_rows),
    }


def write_synthetic_cache(
    raw_data_dir: Path, cfg: SyntheticConfig | None = None
) -> Dict[str, Path]:
    """Persist the synthetic datasets under the pipeline's cache file names
    (parquet, each written atomically by ``utils.cache.save_cache_data``)."""
    data = generate_synthetic_wrds(cfg)
    return {key: save_cache_data(data[key], raw_data_dir, file_name=name)
            for key, name in FILE_NAMES.items()}
