"""A synthetic universe at real-CRSP scale, vectorized (host numpy/pandas).

``data.synthetic`` builds its fixtures row by row, right for tests and far
too slow at the real data volume (1964-2013: ~25k permnos, ~77M firm-day
rows). This module generates the same five raw datasets by numpy column
construction (repeat/cumsum-offset arithmetic, categorical codes for the
flag columns), so a full-size universe materializes in tens of seconds and
the end-to-end path (the WRDS pullers' caches, the columnar ingest, the
task graph) runs at the shape a real run has. The reference package's
generator, the same frames for the same arguments.

Statistical content is minimal but coherent: firms have contiguous
lifetimes, daily returns load on a market factor (betas are recoverable),
and the monthly, fundamental and link tables share the firm vocabulary, so
every join of the pipeline runs at scale. It is not a parity fixture.

``write_benchscale_cache`` writes the frames under the pipeline's raw file
names beside a parameter marker, so a repeated run reuses them.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import pandas as pd
from pandas.tseries.offsets import MonthEnd

from fm_returnprediction_tpu_torch.data.synthetic import FILE_NAMES as _FILE_NAMES

__all__ = ["flat_ranges", "generate_benchscale_wrds", "write_benchscale_cache"]


def flat_ranges(starts: np.ndarray, counts: np.ndarray) -> tuple:
    """Concatenated [starts[i], starts[i]+counts[i]) ranges without a Python
    loop: global arange minus each row's group offset. Returns
    ``(positions, within)`` — the flattened range values and each element's
    offset within its own group."""
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    within = np.arange(offsets[-1], dtype=np.int64) - np.repeat(offsets[:-1], counts)
    return np.repeat(starts.astype(np.int64), counts) + within, within


def _flag_frame(n_rows: int, codes: Dict[str, tuple], rep_codes: Dict[str, np.ndarray]):
    """Share-class flag columns as categoricals (one byte a row instead of
    an object pointer: at 77M rows, 600 MB of frame instead of 6 GB)."""
    out = {}
    for name, values in codes.items():
        c = rep_codes.get(name)
        if c is None:
            c = np.zeros(n_rows, dtype=np.int8)
        out[name] = pd.Categorical.from_codes(c, categories=list(values))
    return out


def generate_benchscale_wrds(
    n_permnos: int = 22000,
    n_months: int = 600,
    seed: int = 20140131,
    start: str = "1964-01-31",
    frac_nyse: float = 0.35,
    frac_noncommon: float = 0.08,
) -> Dict[str, pd.DataFrame]:
    """The five raw datasets (``crsp_m``, ``crsp_d``, ``crsp_index_d``,
    ``comp``, ``ccm``) of ``n_permnos`` firms over ``n_months`` month-ends
    from ``start``, drawn from ``seed``; ``frac_noncommon`` of the firms
    fall outside the common-stock universe."""
    rng = np.random.default_rng(seed)
    months = pd.date_range(start, periods=n_months, freq="ME")
    days = pd.bdate_range(months[0] - MonthEnd(1) + pd.Timedelta(days=1), months[-1])
    d_total = len(days)
    day_me = days + MonthEnd(0)
    day_month = np.searchsorted(months.values, day_me.values)
    month_day_lo = np.searchsorted(day_month, np.arange(n_months), side="left")
    month_day_hi = np.searchsorted(day_month, np.arange(n_months), side="right")

    mkt = rng.normal(3e-4, 0.008, d_total)

    # --- firm vocabulary and lifetimes (contiguous month spans) ----------
    permnos = (10000 + np.arange(n_permnos) * 2).astype(np.int64)
    min_life = min(24, max(n_months // 2, 1))
    m0 = rng.integers(0, max(n_months - min_life, 1), n_permnos)
    life = np.clip(rng.lognormal(5.1, 0.8, n_permnos).astype(np.int64), min_life, None)
    m1 = np.minimum(m0 + life, n_months - 1)

    betas = rng.uniform(0.3, 1.8, n_permnos)
    idio = rng.uniform(0.01, 0.03, n_permnos)
    base_prc = rng.uniform(5, 80, n_permnos)
    base_shr = rng.integers(1_000, 50_000, n_permnos).astype(np.float64)
    issue_rate = rng.uniform(0.0, 0.004, n_permnos)

    common = rng.random(n_permnos) >= frac_noncommon
    exch_code = np.where(
        rng.random(n_permnos) < frac_nyse, 0,
        np.where(rng.random(n_permnos) < 0.7, 1, 2),
    ).astype(np.int8)  # N / Q / A

    flag_values = {
        "issuertype": ("CORP", "ABS"),
        "securitytype": ("EQTY",),
        "securitysubtype": ("COM", "ADR"),
        "sharetype": ("NS",),
        "usincflg": ("Y", "N"),
        "primaryexch": ("N", "Q", "A"),
        "conditionaltype": ("RW",),
        "tradingstatusflg": ("A",),
    }
    noncommon_code = (~common).astype(np.int8)

    # --- daily ------------------------------------------------------------
    d0 = month_day_lo[m0]
    d1 = month_day_hi[m1]
    d_counts = (d1 - d0).astype(np.int64)
    day_idx, _ = flat_ranges(d0, d_counts)
    r_daily = len(day_idx)

    ret = np.repeat(betas, d_counts) * mkt[day_idx]
    ret += rng.standard_normal(r_daily) * np.repeat(idio, d_counts)
    retx = np.where(rng.random(r_daily) < 0.005, np.nan, ret)

    rep = {
        "issuertype": np.repeat(noncommon_code, d_counts),
        "securitysubtype": np.repeat(noncommon_code, d_counts),
        "usincflg": np.repeat(noncommon_code, d_counts),
        "primaryexch": np.repeat(exch_code, d_counts),
    }
    crsp_d = pd.DataFrame(
        {
            "permno": np.repeat(permnos, d_counts),
            "permco": np.repeat(permnos + 50000, d_counts),
            "dlycaldt": days.values[day_idx],
            "totret": retx + 2e-5,
            "retx": retx,
            "prc": np.repeat(base_prc, d_counts),
            "shrout": np.repeat(base_shr, d_counts),
            "jdate": day_me.values[day_idx],
            **_flag_frame(r_daily, flag_values, rep),
        }
    )

    # --- monthly ----------------------------------------------------------
    m_counts = (m1 - m0 + 1).astype(np.int64)
    month_idx, within_m = flat_ranges(m0, m_counts)
    r_m = len(month_idx)
    mretx = rng.normal(0.008, 0.07, r_m)
    shrout_m = np.repeat(base_shr, m_counts) * np.exp(
        within_m * np.log1p(np.repeat(issue_rate, m_counts))
    )
    prc_m = np.repeat(base_prc, m_counts) * np.exp(rng.normal(0.0, 0.15, r_m))
    rep_m = {
        "issuertype": np.repeat(noncommon_code, m_counts),
        "securitysubtype": np.repeat(noncommon_code, m_counts),
        "usincflg": np.repeat(noncommon_code, m_counts),
        "primaryexch": np.repeat(exch_code, m_counts),
    }
    jdate_m = months.values[month_idx]
    crsp_m = pd.DataFrame(
        {
            "permno": np.repeat(permnos, m_counts),
            "permco": np.repeat(permnos + 50000, m_counts),
            "mthcaldt": jdate_m,
            "totret": mretx + 2e-4,
            "retx": mretx,
            "prc": prc_m,
            "shrout": shrout_m,
            "vol": shrout_m * 1000.0
            * np.repeat(rng.uniform(0.02, 0.20, n_permnos), m_counts)
            * rng.lognormal(0.0, 0.4, r_m),
            "jdate": jdate_m,
            **_flag_frame(r_m, flag_values, rep_m),
        }
    )

    # --- index ------------------------------------------------------------
    crsp_index_d = pd.DataFrame(
        {
            "caldt": days,
            "vwretd": mkt + 1e-4,
            "vwretx": mkt,
            "ewretd": mkt * 1.1,
            "ewretx": mkt * 1.1,
            "sprtrn": mkt * 0.95,
        }
    )

    # --- Compustat annual (all fiscal years touching the firm's life) -----
    y0 = months.year.values[m0] - 1
    y1 = months.year.values[m1]
    y_counts = (y1 - y0 + 1).astype(np.int64)
    year_flat, _ = flat_ranges(y0, y_counts)
    r_y = len(year_flat)
    assets = np.repeat(rng.uniform(50, 5000, n_permnos), y_counts) * np.exp(
        rng.normal(0.08, 0.15, r_y)
    )
    earnings = assets * rng.normal(0.04, 0.05, r_y)
    comp = pd.DataFrame(
        {
            "gvkey": np.char.add("1", np.char.zfill(
                np.repeat(np.arange(n_permnos), y_counts).astype("U5"), 5)),
            "datadate": pd.to_datetime(
                {"year": year_flat, "month": 12, "day": 31}
            ),
            "fyear": year_flat,
            "sales": assets * rng.uniform(0.4, 1.5, r_y),
            "earnings": earnings,
            "assets": assets,
            "accruals": rng.normal(0, 0.05, r_y) * assets,
            "non_cash_current_assets": assets * 0.3,
            "lct": assets * 0.2,
            "total_debt": assets * rng.uniform(0.0, 0.6, r_y),
            "depreciation": assets * 0.04,
            "dvpd": earnings * 0.3,
            "dvc": np.maximum(earnings, 0.0) * 0.25,
            "dvt": earnings * 0.3,
            "pstk": np.where(rng.random(r_y) < 0.5, np.nan, assets * 0.01),
            "pstkl": np.where(rng.random(r_y) < 0.5, np.nan, assets * 0.012),
            "pstkrv": np.where(rng.random(r_y) < 0.5, np.nan, assets * 0.011),
            "txditc": np.where(rng.random(r_y) < 0.3, np.nan, assets * 0.02),
            "seq": assets * rng.uniform(0.2, 0.7, r_y),
        }
    )

    # --- CCM links --------------------------------------------------------
    open_link = rng.random(n_permnos) < 0.2
    linkend = months.values[m1].copy()
    ccm = pd.DataFrame(
        {
            "gvkey": np.char.add("1", np.char.zfill(
                np.arange(n_permnos).astype("U5"), 5)),
            "permno": permnos,
            "linktype": "LU",
            "linkprim": "P",
            "linkdt": months.values[m0] - np.timedelta64(370, "D"),
            "linkenddt": pd.Series(linkend).mask(open_link, pd.NaT),
        }
    )
    return {
        "crsp_m": crsp_m,
        "crsp_d": crsp_d,
        "crsp_index_d": crsp_index_d,
        "comp": comp,
        "ccm": ccm,
    }


def write_benchscale_cache(
    raw_data_dir, n_permnos: int = 22000, n_months: int = 600, seed: int = 20140131
) -> Path:
    """Generate-once cache: reuses the existing files when the parameter
    marker matches, so only the first run pays generation and parquet
    writes. Returns ``raw_data_dir``."""
    raw_data_dir = Path(raw_data_dir)
    marker = raw_data_dir / "benchscale.json"
    # "v" is the generated schema's version (v2: the monthly volume column
    # of the opt-in turnover characteristic), the reference package's, so
    # either package reuses the other's cache and an older one regenerates
    params = {"n_permnos": n_permnos, "n_months": n_months, "seed": seed, "v": 2}
    if marker.is_file():
        try:
            if json.loads(marker.read_text()) == params and all(
                (raw_data_dir / name).is_file() for name in _FILE_NAMES.values()
            ):
                return raw_data_dir
        except (ValueError, OSError):
            pass
    data = generate_benchscale_wrds(n_permnos=n_permnos, n_months=n_months, seed=seed)
    raw_data_dir.mkdir(parents=True, exist_ok=True)
    for key, name in _FILE_NAMES.items():
        data[key].to_parquet(raw_data_dir / name, index=False)
    marker.write_text(json.dumps(params))
    return raw_data_dir
