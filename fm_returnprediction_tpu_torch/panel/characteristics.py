"""The characteristic engine: all 15 Lewellen firm-month variables.

The dense monthly panel goes through lags and rolling windows on the
per-firm compacted axis (pandas ``groupby("permno")`` row semantics), the
two daily characteristics come from the compacted daily strips
(``ops.daily_chunked``), and every published characteristic is winsorized
at [1%, 99%] per month over the full cross-section.

Variable definitions (quirks of the reference preserved):

- ``log_size``        = log(me_{t-1})
- ``log_bm``          = log(be_{t-1}) − log(me_{t-1})
- ``return_12_2``     = prod(1+retx_{t-12..t-2}) − 1, 11 full rows
- ``accruals_final``  = accruals − depreciation
- ``roa``             = earnings / assets
- ``log_assets_growth`` = log(assets_t / assets_{t-12})
- ``dy``              = 12-row sum of dvc / prc_{t-1}
- ``log_return_13_36``= 24-row sum of log(1+retx) shifted 13
- ``log_issues_12/36``= log(shrout_{t-1}) − log(shrout_{t-12/36})
- ``debt_price``      = total_debt / me_{t-1}
- ``sales_price``     = sales / me_{t-1}
- ``beta``            = weekly-grid rolling beta
- ``rolling_std_252`` = annualized 252-day rolling std
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.ops.compaction import lag, make_compaction
from fm_returnprediction_tpu_torch.ops.daily_chunked import (
    daily_characteristics_compact_chunked,
)
from fm_returnprediction_tpu_torch.ops.quantiles import winsorize_cs_batched
from fm_returnprediction_tpu_torch.ops.rolling import (
    rolling_mean,
    rolling_prod,
    rolling_sum,
)
from fm_returnprediction_tpu_torch.panel.daily import CompactDaily
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.utils.timing import StageTimer

__all__ = [
    "FACTORS_DICT",
    "BASE_COLUMNS",
    "TURNOVER_LABEL",
    "TURNOVER_COLUMN",
    "compute_monthly_characteristics",
    "get_factors",
]

# Display-name → column map (Table 1/2 row labels depend on it).
FACTORS_DICT: Dict[str, str] = {
    "Return (%)": "retx",
    "Log Size (-1)": "log_size",
    "Log B/M (-1)": "log_bm",
    "Return (-2, -12)": "return_12_2",
    "Log Issues (-1,-12)": "log_issues_12",
    "Accruals (-1)": "accruals_final",
    "ROA (-1)": "roa",
    "Log Assets Growth (-1)": "log_assets_growth",
    "Dividend Yield (-1,-12)": "dy",
    "Log Return (-13,-36)": "log_return_13_36",
    "Log Issues (-1,-36)": "log_issues_36",
    "Beta (-1,-36)": "beta",
    "Std Dev (-1,-12)": "rolling_std_252",
    "Debt/Price (-1)": "debt_price",
    "Sales/Price (-1)": "sales_price",
}

BASE_COLUMNS = [
    "retx", "prc", "shrout", "me", "be", "accruals", "depreciation",
    "earnings", "assets", "sales", "total_debt", "dvc", "is_nyse",
]

# Opt-in 16th characteristic: average monthly share turnover over months
# t-12..t-1 (vol / shares outstanding, all 12 required).
TURNOVER_LABEL = "Turnover (-1,-12)"
TURNOVER_COLUMN = "turnover_12"

_MONTHLY_OUT = [
    "log_size", "log_bm", "return_12_2", "accruals_final", "roa",
    "log_assets_growth", "dy", "log_return_13_36", "log_issues_12",
    "log_issues_36", "debt_price", "sales_price",
]


def compute_monthly_characteristics(
    values: torch.Tensor, mask: torch.Tensor, var_index: Dict[str, int]
) -> Dict[str, torch.Tensor]:
    """All monthly (non-daily) characteristics.

    ``values``: (T, N, K) base panel; ``mask``: (T, N) bool; ``var_index``
    maps each BASE_COLUMNS name (and ``vol`` with turnover) to its K index.
    """
    plan = make_compaction(mask)
    names = ["retx", "prc", "shrout", "me", "be", "accruals", "depreciation",
             "earnings", "assets", "sales", "total_debt", "dvc"]
    if "vol" in var_index:
        names.append("vol")
    sel = values[:, :, [var_index[n] for n in names]]
    compd = torch.gather(sel, 0, plan.order[:, :, None].expand_as(sel))
    compd = torch.where(plan.valid[:, :, None], compd,
                        torch.full_like(compd, float("nan")))
    col = {n: compd[:, :, i] for i, n in enumerate(names)}
    retx, prc, shrout = col["retx"], col["prc"], col["shrout"]
    me, be = col["me"], col["be"]

    me_lag, be_lag = lag(me, 1), lag(be, 1)
    out = {
        "log_size": torch.log(me_lag),
        "log_bm": torch.log(be_lag) - torch.log(me_lag),
        "return_12_2": rolling_prod(1.0 + lag(retx, 2), 11, 11) - 1.0,
        "accruals_final": col["accruals"] - col["depreciation"],
        "roa": col["earnings"] / col["assets"],
        "log_assets_growth": torch.log(col["assets"] / lag(col["assets"], 12)),
        "dy": rolling_sum(col["dvc"], 12, 1) / lag(prc, 1),
        "log_return_13_36": rolling_sum(lag(torch.log1p(retx), 13), 24, 24),
        "log_issues_12": torch.log(lag(shrout, 1)) - torch.log(lag(shrout, 12)),
        "log_issues_36": torch.log(lag(shrout, 1)) - torch.log(lag(shrout, 36)),
        "debt_price": col["total_debt"] / me_lag,
        "sales_price": col["sales"] / me_lag,
    }
    if "vol" in var_index:
        turnover = col["vol"] / (shrout * 1000.0)
        out[TURNOVER_COLUMN] = rolling_mean(lag(turnover, 1), 12, 12)
    stacked = torch.stack(list(out.values()), dim=-1)
    back = torch.gather(stacked, 0, plan.inv_order[:, :, None].expand_as(stacked))
    back = torch.where(plan.mask[:, :, None], back,
                       torch.full_like(back, float("nan")))
    return {name: back[:, :, i] for i, name in enumerate(out)}


def _panel_characteristics(values, mask, extras, var_index, base_win_idx,
                           extra_win):
    """Monthly characteristics + daily append + winsorize + panel assembly.

    ``extras`` — the daily (T, N) columns appended after the monthly ones
    (in sorted name order); ``base_win_idx`` — indices of BASE columns to
    winsorize; ``extra_win`` — one bool per appended column, True when the
    column winsorizes. Winsorized and untouched columns concatenate in
    output order (a clipped column never changes position)."""
    monthly = compute_monthly_characteristics(values, mask, var_index)
    appended = [monthly[n] for n in sorted(monthly)]
    appended += [e.to(values.dtype) for e in extras]
    if len(extra_win) != len(appended):
        raise ValueError(
            f"extra_win has {len(extra_win)} flags for {len(appended)} columns"
        )
    cols = torch.stack(
        [values[:, :, i] for i in base_win_idx]
        + [e for e, w in zip(appended, extra_win) if w],
        dim=0,
    )
    win = winsorize_cs_batched(cols, mask)

    pieces = []
    prev = 0
    for j, i in enumerate(base_win_idx):
        if i > prev:
            pieces.append(values[:, :, prev:i])
        pieces.append(win[j][:, :, None])
        prev = i + 1
    if prev < values.shape[-1]:
        pieces.append(values[:, :, prev:])
    j = len(base_win_idx)
    for e, w in zip(appended, extra_win):
        if w:
            pieces.append(win[j][:, :, None])
            j += 1
        else:
            pieces.append(e[:, :, None])
    return torch.cat(pieces, dim=-1)


def get_factors(
    dense_base: DensePanel,
    compact_daily: CompactDaily,
    dtype: torch.dtype = torch.float32,
    device=None,
    include_turnover: bool = False,
    timer: Optional[StageTimer] = None,
) -> Tuple[DensePanel, Dict[str, str]]:
    """All 15 characteristics from the prepared inputs, winsorized; returns
    the enriched panel (values a tensor on ``device``) and the display-name
    map.

    ``dense_base`` is the dense base panel over BASE_COLUMNS (+ ``vol`` with
    ``include_turnover``); ``compact_daily`` the compacted daily strips,
    whose month vocabulary must be the panel's months.
    """
    device = resolve_device(device)
    timer = timer or StageTimer(device)
    panel = dense_base
    base_columns = list(BASE_COLUMNS)
    factors_dict = dict(FACTORS_DICT)
    if include_turnover:
        if "vol" not in panel.var_names:
            raise KeyError("include_turnover needs a 'vol' column in the base panel")
        base_columns.append("vol")
        factors_dict[TURNOVER_LABEL] = TURNOVER_COLUMN
    cd = compact_daily
    if cd.n_months != len(panel.months):
        raise ValueError(
            f"compact_daily was built against {cd.n_months} months but the "
            f"monthly panel has {len(panel.months)}"
        )
    with timer.stage("daily_kernels"):
        vol_np, beta_np = daily_characteristics_compact_chunked(
            cd.row_values, cd.row_pos, cd.offsets, cd.mkt, cd.mkt_present,
            cd.day_month_id, cd.week_id, cd.week_month_id,
            cd.n_days, cd.n_weeks, cd.n_months, device=device, dtype=dtype,
        )
    with timer.stage("daily_merge"):
        # left-merge the daily firm columns onto the monthly permno vocabulary
        daily_ids = cd.ids
        pos = np.searchsorted(daily_ids, panel.ids)
        pos_c = np.clip(pos, 0, len(daily_ids) - 1)
        hit = daily_ids[pos_c] == panel.ids
        keep = hit[None, :] & np.asarray(panel.mask)
        vol_m = np.where(keep, vol_np[:, pos_c], np.nan)
        beta_m = np.where(keep, beta_np[:, pos_c], np.nan)

    with timer.stage("characteristics_winsorize"):
        var_index = {name: panel.var_index(name) for name in base_columns}
        values = torch.tensor(np.asarray(panel.values), dtype=dtype,
                                 device=device)
        mask = torch.tensor(np.asarray(panel.mask), device=device)
        monthly_names = list(_MONTHLY_OUT)
        if include_turnover:
            monthly_names.append(TURNOVER_COLUMN)
        new_names = sorted(monthly_names) + ["rolling_std_252", "beta"]
        overlap = set(new_names) & set(panel.var_names)
        if overlap:
            raise ValueError(f"characteristic names collide with base: {overlap}")
        win_names = set(factors_dict.values())
        base_win_idx = tuple(
            i for i, n in enumerate(panel.var_names) if n in win_names
        )
        extra_win = tuple(n in win_names for n in new_names)
        extras = [torch.as_tensor(a, dtype=dtype, device=device)
                  for a in (vol_m, beta_m)]
        values = _panel_characteristics(values, mask, extras, var_index,
                                        base_win_idx, extra_win)
    final = DensePanel(
        values=values,
        mask=np.asarray(panel.mask),
        months=panel.months,
        ids=panel.ids,
        var_names=list(panel.var_names) + new_names,
    )
    return final, factors_dict
