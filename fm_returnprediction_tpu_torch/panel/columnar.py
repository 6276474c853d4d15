"""Columnar panel build: raw parquet → dense base panel, without pandas joins.

The legacy ingest (``pipeline.load_raw_data`` → ``panel.transform_crsp`` /
``panel.transform_compustat`` → ``panel.dense.long_to_dense``) is a chain of
pandas frame materializations and relational merges whose cost is Python
objects and block management, not arithmetic. Every one of those joins is
a sorted-key lookup over integer-factorized keys, so this module does the
whole path with numpy ``lexsort``/``searchsorted``/gather over the chunked
Arrow columns of ``data.columnar``:

- the monthly universe filter runs on the parquet batches' dictionary
  codes, so only surviving rows are ever materialized;
- market equity is a segmented Kahan group sum plus a per-(permco, date)
  representative pick — Kahan because pandas' ``groupby.sum`` compensates,
  and the contract is exact equality with the legacy route;
- the Compustat annual→monthly expansion is the legacy module's grid
  arithmetic with the ``merge_asof`` replaced by an encoded searchsorted;
- the CCM link-window join and the CRSP inner join reduce to one
  candidate expansion + segment argmax (``long_to_dense`` keeps the LAST
  duplicate (permno, jdate) row, which is the link with the largest gvkey,
  so the join picks it directly);
- the dense (T, N, K) base panel scatters straight from the factorized
  (month, firm) keys;
- the daily file streams through the same filtered reader into
  ``panel.daily.build_compact_daily_arrays``.

Contract: from the same raw directory the columnar and legacy routes give
bit-identical ``DensePanel`` bases (values, mask, vocabularies) and
``CompactDaily`` strips, in the port and in the reference package alike
(``tests/test_torch_columnar.py``). The route is chosen in
``pipeline.load_or_build_panel`` (``FMRP_PANEL_ROUTE``, default columnar); a
:class:`~fm_returnprediction_tpu_torch.data.columnar.ColumnarIngestError`
falls back to the legacy route with a warning.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.data.columnar import (
    read_filtered_columns,
    read_table_columns,
)
from fm_returnprediction_tpu_torch.data.synthetic import FILE_NAMES
from fm_returnprediction_tpu_torch.data.wrds_pull import UNIVERSE_FLAGS
from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.guard.contracts import numpy_dtype
from fm_returnprediction_tpu_torch.panel.characteristics import BASE_COLUMNS, get_factors
from fm_returnprediction_tpu_torch.panel.daily import (
    CompactDaily,
    build_compact_daily_arrays,
)
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.settings import config
from fm_returnprediction_tpu_torch.utils.timing import StageTimer

__all__ = [
    "build_panel_columnar",
    "build_dense_base_columnar",
    "ingest_compact_daily_columnar",
]

# Fundamental columns carried from Compustat into the base panel — the
# BASE_COLUMNS sources that come from comp.funda rather than CRSP.
_COMP_CARRY = [
    "be", "accruals", "depreciation", "earnings", "assets", "sales",
    "total_debt", "dvc",
]


def _dt_i8(a: np.ndarray) -> np.ndarray:
    """datetime64 (any unit) → int64 ns — the common key unit for joins.

    Raw WRDS/parquet dates are day-aligned instants well inside the int64
    ns range (1677-2262), so the ns view is lossless and both routes land
    on the same ``datetime64[ns]`` vocabularies pandas produces."""
    if a.dtype.kind != "M":
        a = np.asarray(pd.DatetimeIndex(a), dtype="datetime64[ns]")
    return a.astype("datetime64[ns]").view(np.int64)


def _add_months(dates_ns: np.ndarray, months: int) -> np.ndarray:
    """``date + pd.DateOffset(months=k)`` vectorized: month arithmetic with
    the day-of-month clamped to the target month's length (Oct 31 + 4 →
    Feb 28), bit-matching pandas' scalar offset."""
    d = dates_ns.view("datetime64[ns]").astype("datetime64[D]")
    m = d.astype("datetime64[M]")
    day = (d - m).astype(np.int64)            # 0-based day of month
    m2 = m + np.timedelta64(months, "M")
    dim = ((m2 + np.timedelta64(1, "M")).astype("datetime64[D]")
           - m2.astype("datetime64[D]")).astype(np.int64)
    out = m2.astype("datetime64[D]") + np.minimum(day, dim - 1)
    return out.astype("datetime64[ns]").view(np.int64)


def _kahan_segment_sum(
    values: np.ndarray, starts: np.ndarray, counts: np.ndarray
) -> np.ndarray:
    """Per-segment sum with Kahan compensation in SEGMENT ROW ORDER —
    pandas' ``groupby.sum`` kernel compensates the same way, and matching
    it is what makes the market-equity column bit-identical to the legacy
    route. Vectorized over segments by member rank: iteration k adds every
    segment's k-th element, so the loop runs max-segment-size times (the
    number of securities per (permco, month) — single digits) over shrinking
    index sets, not once per row."""
    n = len(starts)
    total = np.zeros(n, dtype=np.float64)
    comp = np.zeros(n, dtype=np.float64)
    live = np.flatnonzero(counts > 0)
    k = 0
    while len(live):
        v = values[starts[live] + k]
        y = v - comp[live]
        t = total[live] + y
        comp[live] = (t - total[live]) - y
        total[live] = t
        k += 1
        live = live[counts[live] > k]
    return total


def _segment_bounds(sorted_keys_equal_prev: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, counts) of contiguous segments given a "same key as
    previous row" boolean (first element False/absent handled by caller
    passing ``new_segment`` = ~same)."""
    starts = np.flatnonzero(sorted_keys_equal_prev)
    counts = np.diff(np.append(starts, len(sorted_keys_equal_prev)))
    return starts, counts


def _market_equity(m: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``panel.transform_crsp.calculate_market_equity`` over bare arrays.

    Per (permno, jdate): security ME = |prc|·shrout. Per (permco, jdate):
    firm ME = Kahan sum of security MEs in row order, assigned to the
    permno with the largest security ME (ties → ascending permno); other
    permnos of the firm-date drop. Output rows are (permco, jdate)-sorted,
    like the legacy ``sort_values`` + ``drop_duplicates`` product."""
    ok = ~(np.isnan(m["prc"]) | np.isnan(m["shrout"]))
    cols = {k: v[ok] for k, v in m.items()}
    permno_me = np.abs(cols["prc"]) * cols["shrout"]
    jd = cols["jdate_i8"]
    permco = cols["permco"]
    n = len(permco)
    if n == 0:
        return {**{k: v for k, v in cols.items() if k != "permco"},
                "me": permno_me}

    # stable (permco, jdate) grouping keeps original row order within each
    # group — the order pandas' grouped Kahan sum accumulates in
    order = np.lexsort((jd, permco))
    pc_s, jd_s = permco[order], jd[order]
    new_seg = np.empty(n, dtype=bool)
    new_seg[0] = True
    new_seg[1:] = (pc_s[1:] != pc_s[:-1]) | (jd_s[1:] != jd_s[:-1])
    starts, counts = _segment_bounds(new_seg)
    me_group = _kahan_segment_sum(permno_me[order], starts, counts)

    # representative pick: resort with (permno_me desc, permno asc) as
    # tie-breakers and take each group's first row. Group enumeration is
    # (permco, jdate)-ascending in both sorts, so ``me_group`` aligns.
    order2 = np.lexsort((cols["permno"], -permno_me, jd, permco))
    pc2, jd2 = permco[order2], jd[order2]
    first = np.empty(n, dtype=bool)
    first[0] = True
    first[1:] = (pc2[1:] != pc2[:-1]) | (jd2[1:] != jd2[:-1])
    rep = order2[first]

    out = {k: v[rep] for k, v in cols.items() if k != "permco"}
    out["me"] = me_group
    return out


def _expand_compustat(c: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``add_report_date`` + ``calc_book_equity`` +
    ``expand_compustat_annual_to_monthly`` over bare arrays.

    Returns the expanded monthly series sorted by (gvkey, fund_date):
    ``gv_code`` (codes into the lexicographically sorted gvkey vocabulary),
    ``fund_i8`` (ns), and per-row source indices ``src`` into the carried
    fundamental columns (gathered lazily at merge time)."""
    report_i8 = _add_months(_dt_i8(c["datadate"]), 4)

    # book equity with the preferred-stock fallback chain
    ps = np.where(np.isnan(c["pstkrv"]), c["pstkl"], c["pstkrv"])
    ps = np.where(np.isnan(ps), c["pstk"], ps)
    ps = np.where(np.isnan(ps), 0.0, ps)
    tx = np.where(np.isnan(c["txditc"]), 0.0, c["txditc"])
    be = c["seq"] + tx - ps
    be = np.where(be > 0, be, np.nan)
    keep = ~np.isnan(be)

    gv_vocab, gv_code = np.unique(np.asarray(c["gvkey"])[keep],
                                  return_inverse=True)
    fund = report_i8[keep]
    carried = {"be": be[keep]}
    for name in _COMP_CARRY:
        if name != "be":
            carried[name] = np.asarray(c[name])[keep]

    # sort by (gvkey, fund_date) stable; keep-LAST duplicate (gvkey, date)
    order = np.lexsort((fund, gv_code))
    gv_s, fund_s = gv_code[order], fund[order]
    nrows = len(order)
    if nrows == 0:
        return {"gv_vocab": gv_vocab, "gv_code": gv_s, "fund_i8": fund_s,
                "src": order, "carried": carried}
    last = np.empty(nrows, dtype=bool)
    last[-1] = True
    last[:-1] = (gv_s[1:] != gv_s[:-1]) | (fund_s[1:] != fund_s[:-1])
    order, gv_s, fund_s = order[last], gv_s[last], fund_s[last]

    # per-firm bounds over the deduped sorted rows
    first = np.empty(len(gv_s), dtype=bool)
    first[0] = True
    first[1:] = gv_s[1:] != gv_s[:-1]
    f_start, f_count = _segment_bounds(first)
    firm_codes = gv_s[f_start]
    fund_min = fund_s[f_start]
    fund_max = fund_s[f_start + f_count - 1]

    # month grid per firm: month-ends from the first report month to
    # min(last report + 12 months, global max), a month included only if
    # its month-END is <= the cap (pd.date_range(freq='ME') semantics)
    global_max = fund_s.max()
    end_i8 = np.minimum(_add_months(fund_max, 12), global_max)
    end_d = end_i8.view("datetime64[ns]").astype("datetime64[D]")
    end_m = end_d.astype("datetime64[M]")
    start_m = (fund_min.view("datetime64[ns]")
               .astype("datetime64[D]").astype("datetime64[M]"))
    end_is_me = ((end_d + 1).astype("datetime64[M]") != end_m) & (
        # month-end at MIDNIGHT: the ns value must be exactly the day
        (end_i8 == end_d.astype("datetime64[ns]").view(np.int64))
    )
    n_grid = (end_m - start_m).astype(np.int64) + np.where(end_is_me, 1, 0)
    keep_f = n_grid > 0
    firm_codes, start_m, n_grid = firm_codes[keep_f], start_m[keep_f], n_grid[keep_f]

    g_off = np.zeros(len(n_grid) + 1, dtype=np.int64)
    np.cumsum(n_grid, out=g_off[1:])
    within = np.arange(g_off[-1], dtype=np.int64) - np.repeat(g_off[:-1], n_grid)
    grid_gv = np.repeat(firm_codes, n_grid)
    grid_m = np.repeat(start_m, n_grid) + within.astype("timedelta64[M]")
    # month-end = first day of next month minus one day, at midnight
    grid_i8 = ((grid_m + np.timedelta64(1, "M")).astype("datetime64[D]")
               - np.timedelta64(1, "D")).astype("datetime64[ns]").view(np.int64)

    # asof backward: the latest report with fund_date <= grid date, per
    # firm — an encoded searchsorted over the (gvkey, date)-sorted reports
    vocab = np.unique(np.concatenate([fund_s, grid_i8]))
    v_span = len(vocab) + 1
    rkey = gv_s * v_span + np.searchsorted(vocab, fund_s)
    gkey = grid_gv * v_span + np.searchsorted(vocab, grid_i8)
    j = np.searchsorted(rkey, gkey, side="right") - 1
    hit = (j >= 0) & (gv_s[np.maximum(j, 0)] == grid_gv)
    j, grid_gv, grid_i8 = j[hit], grid_gv[hit], grid_i8[hit]

    return {
        "gv_vocab": gv_vocab,
        "gv_code": grid_gv,
        "fund_i8": grid_i8,
        "src": order[j],          # row into ``carried``
        "carried": carried,
    }


def _ccm_inner_join(
    crsp: Dict[str, np.ndarray],
    comp: Dict[str, np.ndarray],
    ccm: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """``merge_CRSP_and_Compustat`` over arrays: CCM link-window join then
    inner join to CRSP on (permno, jdate).

    Duplicate handling: when several valid links give one (permno, jdate)
    multiple fundamental rows, the legacy path emits them all and
    ``long_to_dense`` keeps the LAST — which, because the linked frame is
    (gvkey, date)-sorted, is the largest gvkey. The join here picks that
    winner directly (CCM columns themselves are dropped by the legacy
    merge, so ties within one gvkey are value-identical)."""
    gv_vocab = comp["gv_vocab"]
    if len(gv_vocab) == 0:
        # every fundamental row dropped (e.g. all-null seq → no book
        # equity): no link can resolve, the inner join is empty — numpy's
        # `&` is eager, so this cannot be folded into the np.where below
        lgv = np.full(len(np.asarray(ccm["gvkey"])), -1, dtype=np.int64)
    else:
        lgv_pos = np.searchsorted(gv_vocab, ccm["gvkey"])
        lgv_pos_c = np.minimum(lgv_pos, len(gv_vocab) - 1)
        lgv = np.where(
            np.asarray(gv_vocab)[lgv_pos_c] == np.asarray(ccm["gvkey"]),
            lgv_pos_c, -1,
        )
    linkdt = _dt_i8(ccm["linkdt"])
    linkend_raw = np.asarray(ccm["linkenddt"], dtype="datetime64[ns]")
    today = pd.to_datetime("today").to_datetime64().astype("datetime64[ns]")
    linkend = np.where(np.isnat(linkend_raw), today, linkend_raw).view(np.int64)

    # candidate links per crsp row, via the permno-sorted link table
    lorder = np.lexsort((np.arange(len(lgv)), ccm["permno"]))
    lpermno = np.asarray(ccm["permno"])[lorder]
    lo = np.searchsorted(lpermno, crsp["permno"], side="left")
    hi = np.searchsorted(lpermno, crsp["permno"], side="right")
    cnt = hi - lo
    pair_row = np.repeat(np.arange(len(cnt)), cnt)
    off = np.zeros(len(cnt) + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    pair_link = (np.repeat(lo, cnt)
                 + np.arange(off[-1], dtype=np.int64)
                 - np.repeat(off[:-1], cnt))
    pair_link = lorder[pair_link]

    jd = crsp["jdate_i8"][pair_row]
    ok = (
        (lgv[pair_link] >= 0)
        & (jd >= linkdt[pair_link])
        & (jd <= linkend[pair_link])
    )
    pair_row, pair_gv, jd = pair_row[ok], lgv[pair_link[ok]], jd[ok]

    # (gvkey, jdate) lookup into the expanded monthly fundamentals
    vocab = np.unique(np.concatenate([comp["fund_i8"], jd]))
    v_span = len(vocab) + 1
    ckey = comp["gv_code"] * v_span + np.searchsorted(vocab, comp["fund_i8"])
    pkey = pair_gv * v_span + np.searchsorted(vocab, jd)
    if len(ckey) == 0:  # empty expansion: nothing can match (eager `&`)
        found = np.zeros(len(pkey), dtype=bool)
        pos_c = np.zeros(len(pkey), dtype=np.int64)
    else:
        pos = np.searchsorted(ckey, pkey)
        pos_c = np.minimum(pos, len(ckey) - 1)
        found = ckey[pos_c] == pkey
    pair_row, pair_gv, pos_c = pair_row[found], pair_gv[found], pos_c[found]

    # keep-last winner per crsp row = max gvkey among matches
    worder = np.lexsort((pair_gv, pair_row))
    pr_s = pair_row[worder]
    is_last = np.empty(len(pr_s), dtype=bool)
    if len(pr_s):
        is_last[-1] = True
        is_last[:-1] = pr_s[1:] != pr_s[:-1]
    win = worder[is_last]
    rows, comp_rows = pair_row[win], pos_c[win]

    merged = {k: v[rows] for k, v in crsp.items()}
    src = comp["src"][comp_rows]
    for name in _COMP_CARRY:
        merged[name] = comp["carried"][name][src]
    return merged


def _has_column(path: Path, name: str) -> bool:
    """Whether the parquet file at ``path`` has column ``name`` (False when
    it cannot be probed; the read that follows then reports why)."""
    try:
        import pyarrow.parquet as pq

        return name in pq.ParquetFile(path).schema_arrow.names
    except Exception:  # noqa: BLE001 - a probe only
        return False


def build_dense_base_columnar(
    raw_data_dir,
    dtype=np.float64,
    include_turnover: bool = False,
    timer: Optional[StageTimer] = None,
) -> DensePanel:
    """Raw parquet → the dense (T, N, K) host base panel (BASE_COLUMNS
    [+ vol]) in the numpy ``dtype``, every relational stage vectorized: the
    columnar replacement for ``load_raw_data`` + the pandas transforms +
    ``long_to_dense``."""
    timer = timer or StageTimer("cpu")
    raw = Path(raw_data_dir)

    with timer.stage("panel/monthly_ingest"):
        value_cols = ["permno", "permco", "jdate", "retx", "prc", "shrout"]
        if include_turnover and _has_column(raw / FILE_NAMES["crsp_m"], "vol"):
            # volume is read only when the file has it; get_factors reports
            # its absence
            value_cols.append("vol")
        m = read_filtered_columns(
            raw / FILE_NAMES["crsp_m"], value_cols, UNIVERSE_FLAGS,
            bool_columns={"primaryexch": ("N",)},
        )
        m["jdate_i8"] = _dt_i8(m.pop("jdate"))
        m["is_nyse"] = m.pop("primaryexch").astype(np.float64)

    with timer.stage("panel/market_equity"):
        crsp = _market_equity(m)
        del m

    with timer.stage("panel/compustat"):
        comp_cols = read_table_columns(
            raw / FILE_NAMES["comp"],
            ["gvkey", "datadate", "pstk", "pstkl", "pstkrv", "txditc", "seq"]
            + [c for c in _COMP_CARRY if c != "be"],
        )
        comp = _expand_compustat(comp_cols)
        del comp_cols

    with timer.stage("panel/ccm_merge"):
        ccm_cols = read_table_columns(raw / FILE_NAMES["ccm"],
                                      ["gvkey", "permno", "linkdt", "linkenddt"])
        merged = _ccm_inner_join(crsp, comp, ccm_cols)
        del crsp, comp, ccm_cols

    with timer.stage("panel/dense_scatter"):
        months_i8, t_idx = np.unique(merged["jdate_i8"], return_inverse=True)
        ids, n_idx = np.unique(merged["permno"], return_inverse=True)
        base_columns = list(BASE_COLUMNS)
        if include_turnover and "vol" in merged:
            base_columns.append("vol")
        values = np.full((len(months_i8), len(ids), len(base_columns)), np.nan, dtype=dtype)
        mask = np.zeros((len(months_i8), len(ids)), dtype=bool)
        for k, name in enumerate(base_columns):
            values[t_idx, n_idx, k] = merged[name].astype(dtype)
        mask[t_idx, n_idx] = True
    return DensePanel(values=values, mask=mask, months=months_i8.view("datetime64[ns]"),
                      ids=ids, var_names=base_columns)


def ingest_compact_daily_columnar(raw_data_dir, months: np.ndarray,
                                  dtype=np.float64) -> CompactDaily:
    """The daily file streamed through the dictionary-code universe filter
    (three value columns ever materialized) and packed into the per-firm
    strips of ``build_compact_daily_arrays``, without a daily frame."""
    raw = Path(raw_data_dir)
    d = read_filtered_columns(raw / FILE_NAMES["crsp_d"], ["permno", "dlycaldt", "retx"],
                              UNIVERSE_FLAGS)
    # the index table is small: one row per trading day
    crsp_index_d = pd.DataFrame(read_table_columns(raw / FILE_NAMES["crsp_index_d"],
                                                   ["caldt", "vwretx"]))
    return build_compact_daily_arrays(d["permno"], d["dlycaldt"], d["retx"],
                                      crsp_index_d, months, dtype=dtype)


def build_panel_columnar(
    raw_data_dir,
    dtype=torch.float64,
    mesh=None,
    timer: Optional[StageTimer] = None,
    include_turnover: Optional[bool] = None,
    capture: Optional[dict] = None,
    *,
    device=None,
) -> Tuple[DensePanel, Dict[str, str]]:
    """Raw parquet directory → enriched characteristic panel by the columnar
    route: the counterpart of ``pipeline.load_raw_data`` +
    ``pipeline.build_panel`` (the same return, and the same ``capture``
    products — ``dense_base`` and ``compact_daily`` — for the
    prepared-inputs slot). The host ingest runs in ``dtype``'s numpy dtype
    (a torch or numpy dtype, default float64 as the reference's), the
    characteristics on ``device``; ``include_turnover=None`` follows
    ``INCLUDE_TURNOVER``."""
    device = resolve_device(device)
    timer = timer or StageTimer(device)
    np_dtype = numpy_dtype(dtype)
    if include_turnover is None:
        include_turnover = bool(config("INCLUDE_TURNOVER"))
    with timer.ensure_stage("build_panel"):
        base = build_dense_base_columnar(raw_data_dir, dtype=np_dtype,
                                         include_turnover=include_turnover, timer=timer)
        with timer.stage("factors/daily_ingest"):
            cd = ingest_compact_daily_columnar(raw_data_dir, base.months, dtype=np_dtype)
        if capture is not None:
            capture["dense_base"], capture["compact_daily"] = base, cd
        return get_factors(None, None, None, dtype, mesh, timer=timer,
                           include_turnover=include_turnover, compact_daily=cd,
                           dense_base=base, device=device)
