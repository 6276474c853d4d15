"""WRDS data acquisition: CRSP stock/index, Compustat, the CCM link table.

The reference package's pullers, host pandas only: the same SQL against
the CIZ-format tables, the same universe filter, the same cache-file
names (caches either package wrote read in the other). With the original
pullers' defects fixed as the reference package fixes them: a cache named
from its filters uses the filter string it built; a gvkey filter names the
column (``gvkey IN (...)``); the index cache name interpolates its table;
and a cache hit returns the filtered universe, as a fresh pull does (the
cache keeps the raw pull, so it stays reusable).

The ``wrds`` package (and the network) is optional: it is imported at
the call, so everything works offline against caches or the synthetic
backend. Each query runs under ``resilience.retry`` with the fault site
``wrds.query`` before each connection attempt.
"""
from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import pandas as pd
from pandas.tseries.offsets import MonthEnd

from fm_returnprediction_tpu_torch.utils.cache import (
    cache_filename,
    file_cached,
    flatten_dict_to_str,
    hash_cache_filename,
    read_cached_data,
    save_cache_data,
)

__all__ = [
    "pull_CRSP_stock",
    "pull_CRSP_index",
    "pull_Compustat",
    "pull_CRSP_Comp_link_table",
    "subset_to_common_stock_and_exchanges",
    "UNIVERSE_FLAGS",
    "build_crsp_stock_sql",
    "build_compustat_sql",
    "build_link_table_sql",
    "FLAG_COLUMNS",
]

COMPUSTAT_DEFAULT_VARS = (
    "gvkey, datadate, fyear, sale AS sales, ni AS earnings, at AS assets, "
    "(act - che) - lct - dp AS accruals, "
    "act - che AS non_cash_current_assets,"
    "lct,"
    "dltt + dlc AS total_debt,"
    "dp AS depreciation, "
    "dvpd, dvc, dvt, pstk, pstkl, pstkrv, txditc, seq"
)


def _normalize_dates(start_date, end_date) -> tuple[str, str]:
    if start_date is None:
        start_date = "1959-01-01"
    elif isinstance(start_date, (pd.Timestamp, datetime)):
        start_date = start_date.strftime("%Y-%m-%d")
    if end_date is None:
        end_date = pd.Timestamp.now().strftime("%Y-%m-%d")
    elif isinstance(end_date, (pd.Timestamp, datetime)):
        end_date = end_date.strftime("%Y-%m-%d")
    return start_date, end_date


def _sql_list(values: Union[str, List[str]]) -> str:
    values = (values,) if isinstance(values, str) else tuple(values)
    return "(" + ", ".join(f"'{v}'" for v in values) + ")"


# The CIZ share-class flag columns the universe filter reads (also the
# columns the pipeline's pruned daily read keeps).
FLAG_COLUMNS = [
    "sharetype", "securitytype", "securitysubtype", "usincflg",
    "issuertype", "primaryexch", "conditionaltype", "tradingstatusflg",
]

# The admitted values per flag column — the one definition of the US
# common-stock NYSE/AMEX/NASDAQ universe, read by the pandas filter below
# and by the columnar ingest route (``data.columnar``).
UNIVERSE_FLAGS = {
    "conditionaltype": ("RW",),
    "tradingstatusflg": ("A",),
    "sharetype": ("NS",),
    "securitytype": ("EQTY",),
    "securitysubtype": ("COM",),
    "usincflg": ("Y",),
    "issuertype": ("ACOR", "CORP"),
    "primaryexch": ("N", "A", "Q"),
}


def subset_to_common_stock_and_exchanges(
    crsp: pd.DataFrame, columns: Optional[List[str]] = None
) -> pd.DataFrame:
    """US common-stock universe on NYSE/AMEX/NASDAQ (CIZ flags).

    sharetype NS ∧ securitytype EQTY ∧ securitysubtype COM ∧ usincflg Y ∧
    issuertype ∈ {ACOR, CORP} ∧ conditionaltype RW ∧ tradingstatusflg A ∧
    primaryexch ∈ {N, A, Q} (with the CIZ format delisting returns are
    already applied upstream). ``columns`` limits the RESULT to the named
    columns: at full CRSP daily scale the row-filter copy of every column
    costs far more than the three the daily stage reads.
    """

    def flag_in(name, values):
        col = crsp[name]
        if isinstance(col.dtype, pd.CategoricalDtype):
            # compare int8 category codes, not millions of string rows
            wanted = [
                col.cat.categories.get_loc(v)
                for v in values
                if v in col.cat.categories
            ]
            code = col.cat.codes.to_numpy()
            keep = np.zeros(len(col), dtype=bool)
            for w in wanted:
                keep |= code == w
            return keep
        return col.isin(values).to_numpy()

    keep = None
    for name, values in UNIVERSE_FLAGS.items():
        m = flag_in(name, list(values))
        keep = m if keep is None else keep & m
    out = crsp if columns is None else crsp[columns]
    return out[keep]


def build_crsp_stock_sql(
    freq: str,
    start_date: str,
    end_date: str,
    filter_by: Optional[str] = None,
    filter_value=None,
) -> str:
    """The CIZ stock query, monthly (``M``) or daily (``D``)."""
    if freq.upper() == "M":
        table, date_col = "msf_v2", "mthcaldt"
        tot_ret, prc_ret, prc = "mthret", "mthretx", "mthprc"
        # mthvol (CIZ share volume) feeds the opt-in Turnover_{-1,-12}
        # characteristic
        extra = "mthvol AS vol,"
    elif freq.upper() == "D":
        table, date_col = "dsf_v2", "dlycaldt"
        tot_ret, prc_ret, prc = "dlyret", "dlyretx", "dlyprc"
        extra = ""
    else:
        raise ValueError("freq must be either 'D' or 'M'.")
    sql = f"""
        SELECT
            permno, permco, {date_col},
            issuertype, securitytype, securitysubtype, sharetype,
            usincflg,
            primaryexch, conditionaltype, tradingstatusflg,
            {tot_ret} AS totret,
            {prc_ret} AS retx,
            {prc} AS prc,
            {extra}
            shrout
        FROM crsp.{table}
        WHERE {date_col} >= '{start_date}'
          AND {date_col} <= '{end_date}'
    """
    if filter_by is not None and filter_value is not None:
        sql += f" AND {filter_by} IN {_sql_list(filter_value)}"
    return sql


def build_compustat_sql(
    vars_str: str, start_date: str, end_date: str, gvkey=None
) -> str:
    """Annual fundamentals with derived columns in SQL and the standard
    INDL/STD/D/C filters; the gvkey filter names the column."""
    sql = f"""
        SELECT
            {vars_str}
        FROM
            comp.funda
        WHERE
            indfmt='INDL' AND
            datafmt='STD' AND
            popsrc='D' AND
            consol='C' AND
            datadate >= '{start_date}' AND
            datadate <= '{end_date}'
        """
    if gvkey is not None:
        sql += f" AND gvkey IN {_sql_list(gvkey)}"
    return sql


def build_link_table_sql(gvkey=None) -> str:
    """CCM link table restricted to L*-type primary links."""
    sql = """
        SELECT
            gvkey, lpermno AS permno, linktype, linkprim, linkdt, linkenddt
        FROM
            crsp.ccmxpf_linktable
        WHERE
            substr(linktype,1,1)='L'
            AND (linkprim ='C' OR linkprim='P')
            AND linktype NOT IN ('LX', 'LD', 'LN')
    """
    if gvkey is not None:
        sql += f" AND gvkey IN {_sql_list(gvkey)}"
    return sql


def _resolve_cache(
    code: str,
    filters: dict,
    data_dir,
    file_name: Optional[str],
    hash_file_name: bool,
):
    """Shared cache-path resolution: ``(candidate paths, the cached file
    or None, the file name to save under)``."""
    if file_name is None:
        filter_str = flatten_dict_to_str(filters)
        namer = hash_cache_filename if hash_file_name else cache_filename
        cache_paths = namer(code, filter_str, data_dir)
        return cache_paths, file_cached(cache_paths), None
    if not any(file_name.endswith(f".{ext}") for ext in ("parquet", "csv", "zip")):
        cache_paths = [Path(data_dir) / f"{file_name}.{ext}" for ext in ("parquet", "csv", "zip")]
        return cache_paths, file_cached(cache_paths), file_name
    path = Path(data_dir, file_name)
    return None, (path if path.exists() else None), file_name


def _wrds_query(
    sql: str,
    wrds_username: str,
    date_cols: List[str],
    retries: int = 3,
    backoff_s: float = 5.0,
) -> pd.DataFrame:
    """Run one WRDS query under the retry policy.

    The WRDS Postgres connection is the pipeline's only network boundary.
    Each attempt opens a fresh connection; failures back off exponentially
    with deterministic jitter (``resilience.retry``). Every ``Exception``
    retries: the wrds client wraps transport errors in assorted library
    types, and the failures that cannot heal (bad SQL, bad credentials)
    spend the budget in seconds against a healthy server.

    The fault site ``wrds.query`` fires before each connection attempt, so
    a fault plan drives this loop without network access."""
    import wrds  # at the call: optional dependency, needs the network

    from fm_returnprediction_tpu_torch.resilience.faults import fault_site
    from fm_returnprediction_tpu_torch.resilience.retry import RetryPolicy, call_with_retry

    def attempt() -> pd.DataFrame:
        fault_site("wrds.query")
        db = None
        try:
            db = wrds.Connection(wrds_username=wrds_username)
            return db.raw_sql(sql, date_cols=date_cols)
        finally:
            if db is not None:
                db.close()

    return call_with_retry(
        attempt,
        RetryPolicy(max_attempts=retries + 1, backoff_s=backoff_s, retry_on=(Exception,)),
        label="WRDS query",
        on_retry=lambda n, err: print(f"WRDS retry {n}/{retries} after: {err}"),
    )


def pull_CRSP_stock(
    wrds_username: str = "",
    start_date=None,
    end_date=None,
    freq: str = "D",
    filter_by: Optional[str] = None,
    filter_value=None,
    data_dir=None,
    file_name: Optional[str] = None,
    hash_file_name: bool = False,
    file_type: Optional[str] = None,
) -> pd.DataFrame:
    """CRSP stock data (CIZ), cached, returned as the filtered common-stock
    universe on cache hits and fresh pulls alike."""
    start_date, end_date = _normalize_dates(start_date, end_date)
    freq_u = freq.upper()
    table = "msf_v2" if freq_u == "M" else "dsf_v2"
    date_col = "mthcaldt" if freq_u == "M" else "dlycaldt"

    filters = {"start_date": start_date, "end_date": end_date}
    if filter_by is not None and filter_value is not None:
        filters[filter_by] = filter_value
    cache_paths, cached_fp, file_name = _resolve_cache(
        f"crsp_{table}", filters, data_dir, file_name, hash_file_name
    )
    if cached_fp:
        return subset_to_common_stock_and_exchanges(read_cached_data(cached_fp))

    sql = build_crsp_stock_sql(freq, start_date, end_date, filter_by, filter_value)
    crsp = _wrds_query(sql, wrds_username, date_cols=[date_col])
    crsp[["permno", "permco"]] = crsp[["permno", "permco"]].astype(int, errors="ignore")
    crsp["jdate"] = crsp[date_col] + MonthEnd(0)
    save_cache_data(crsp, data_dir, cache_paths, file_name, file_type)
    return subset_to_common_stock_and_exchanges(crsp)


def pull_CRSP_index(
    wrds_username: str = "",
    start_date=None,
    end_date=None,
    freq: str = "D",
    data_dir=None,
    file_name: Optional[str] = None,
    hash_file_name: bool = False,
    file_type: Optional[str] = None,
) -> pd.DataFrame:
    """CRSP cap-based index files (msix/dsix), cached under a name that
    carries the table."""
    start_date, end_date = _normalize_dates(start_date, end_date)
    table = "msix" if freq.upper() == "M" else "dsix"
    filters = {"start_date": start_date, "end_date": end_date, "freq": freq}
    cache_paths, cached_fp, file_name = _resolve_cache(
        f"crsp_a_index_{table}", filters, data_dir, file_name, hash_file_name
    )
    if cached_fp:
        return read_cached_data(cached_fp)

    sql = f"""
        SELECT *
        FROM crsp_a_indexes.{table}
        WHERE caldt BETWEEN '{start_date}' AND '{end_date}'
    """
    df = _wrds_query(sql, wrds_username, date_cols=["caldt"])
    save_cache_data(df, data_dir, cache_paths, file_name, file_type)
    return df


def pull_Compustat(
    wrds_username: str = "",
    gvkey=None,
    vars_str=None,
    start_date=None,
    end_date=None,
    data_dir=None,
    file_name: Optional[str] = None,
    hash_file_name: bool = False,
    file_type: Optional[str] = None,
) -> pd.DataFrame:
    """Annual Compustat fundamentals with derived columns, cached."""
    start_date, end_date = _normalize_dates(start_date, end_date)
    if vars_str is not None and not isinstance(vars_str, str):
        vars_str = ", ".join(vars_str)
    vars_str = vars_str or COMPUSTAT_DEFAULT_VARS

    filters = {"vars_str": vars_str, "start_date": start_date, "end_date": end_date}
    if gvkey is not None:
        filters["gvkey"] = gvkey
    cache_paths, cached_fp, file_name = _resolve_cache(
        "comp_funda", filters, data_dir, file_name, hash_file_name
    )
    if cached_fp:
        return read_cached_data(cached_fp)

    sql = build_compustat_sql(vars_str, start_date, end_date, gvkey)
    comp = _wrds_query(sql, wrds_username, date_cols=["datadate"])
    save_cache_data(comp, data_dir, cache_paths, file_name, file_type)
    return comp


def pull_CRSP_Comp_link_table(
    wrds_username: str = "",
    gvkey=None,
    data_dir=None,
    file_name: Optional[str] = None,
    hash_file_name: bool = False,
    file_type: Optional[str] = None,
) -> pd.DataFrame:
    """CCM link table, cached."""
    filters = {"gvkey": gvkey} if gvkey is not None else {}
    cache_paths, cached_fp, file_name = _resolve_cache(
        "crsp_comp_link_table", filters, data_dir, file_name, hash_file_name
    )
    if cached_fp:
        return read_cached_data(cached_fp)

    sql = build_link_table_sql(gvkey)
    ccm = _wrds_query(sql, wrds_username, date_cols=["linkdt", "linkenddt"])
    save_cache_data(ccm, data_dir, cache_paths, file_name, file_type)
    return ccm
