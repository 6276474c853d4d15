"""The plain Lewellen (2015) replication: the benchmark's reference.

Written from the paper and the reference package's conventions with plain
PyTorch operations in the caller's dtype; it imports nothing of the program
and reads only the generated inputs (``portbench.inputs.lewellen``):

- daily characteristics: the annualized 252-row rolling standard deviation
  of a firm's daily returns (ddof 1, at least 100 finite rows), read at the
  firm's last daily row of each month; and the beta of weekly log returns
  on the market's over 156-week forward windows that start on the Monday
  lattice, each window stamped with the month of its start, the last
  window of a month kept;
- monthly characteristics on each firm's own rows (a lag is the previous
  row, pandas' ``groupby.shift``), then each published characteristic and
  the return clipped at its monthly 1st and 99th percentiles (linear
  interpolation, months with at least 5 values);
- universes at the NYSE 20th and 50th percentiles of market equity, the
  breakpoints interpolated at the configuration's precision (``universes``);
- Table 1: time-series means of the monthly cross-sectional mean and
  standard deviation, and the number of distinct firms;
- Table 2 and Figure 1 by ``reference.fm``; Figure 1 and the forecasts roll
  120 months (at least 60) over the months whose regression ran;
- the decile sorts on the out-of-sample forecast from the previous months'
  rolling coefficients, and the serving state's lagged coefficient means,
  which carry the last value into months whose regression did not run.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.fm import fm_summary, monthly_cs

FACTORS = {  # display label → column, in Table 1's row order
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
MODELS = {
    "Model 1: Three Predictors": ["log_size", "log_bm", "return_12_2"],
    "Model 2: Seven Predictors": ["log_size", "log_bm", "return_12_2", "log_issues_36",
                                  "accruals_final", "roa", "log_assets_growth"],
    "Model 3: Fourteen Predictors": ["log_size", "log_bm", "return_12_2", "log_issues_12",
                                     "accruals_final", "roa", "log_assets_growth", "dy",
                                     "log_return_13_36", "log_issues_36", "beta",
                                     "rolling_std_252", "debt_price", "sales_price"],
}
FIGURE_VARS = ["log_bm", "return_12_2", "log_issues_36", "accruals_final", "log_assets_growth"]
UNIVERSES = ["All stocks", "All-but-tiny stocks", "Large stocks"]


# -- rows of one firm: compaction, lags, windows -----------------------------


def _compact(v: torch.Tensor, mask: torch.Tensor):
    """Each firm's rows (``mask`` (T, N)) moved to the front in time order:
    ``(rows (T, N) NaN past the firm's count, slot index (T, N))``."""
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    out = torch.full_like(v, float("nan"))
    n_idx = torch.arange(v.shape[1], device=v.device)[None].expand_as(pos)
    out[pos[mask], n_idx[mask]] = v[mask]
    return out, pos


def _expand(c: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The compacted rows put back at their months; NaN where no row."""
    got = torch.gather(c, 0, pos.clamp_min(0))
    return torch.where(mask, got, torch.full_like(got, float("nan")))


def _lag(c: torch.Tensor, k: int) -> torch.Tensor:
    pad = torch.full((k,) + tuple(c.shape[1:]), float("nan"), dtype=c.dtype, device=c.device)
    return torch.cat([pad, c[:-k]], dim=0) if k < c.shape[0] else torch.full_like(c, float("nan"))


def _trailing(c: torch.Tensor, window: int) -> torch.Tensor:
    """Sum over the ``window`` rows ending at each row (fewer at the top)."""
    cs = torch.cumsum(c, dim=0)
    prev = torch.cat([torch.zeros((window,) + tuple(c.shape[1:]), dtype=c.dtype,
                                  device=c.device), cs[:-window]], dim=0)[:c.shape[0]]
    return cs - prev


def _roll_sum(c: torch.Tensor, window: int, min_periods: int) -> torch.Tensor:
    fin = torch.isfinite(c)
    s = _trailing(torch.where(fin, c, 0.0), window)
    n = _trailing(fin.to(c.dtype), window)
    return torch.where(n >= min_periods, s, float("nan"))


def _roll_mean(c: torch.Tensor, window: int, min_periods: int) -> torch.Tensor:
    fin = torch.isfinite(c)
    s = _trailing(torch.where(fin, c, 0.0), window)
    n = _trailing(fin.to(c.dtype), window)
    return torch.where(n >= min_periods, s / n.clamp_min(1.0), float("nan"))


def _roll_prod_full(c: torch.Tensor, window: int) -> torch.Tensor:
    """Product over the ``window`` rows ending at each row, NaN unless all
    ``window`` of them exist and are finite."""
    out = c.clone()
    for k in range(1, window):
        out = out * _lag(c, k)
    return out


# -- daily characteristics -----------------------------------------------------


def daily_characteristics(inp, dtype, device, window: int = 252, min_periods: int = 100,
                          window_weeks: int = 156):
    """``(vol, beta)``, each (T, N), from the daily rows."""
    t = int(inp["n_months"])
    offsets = torch.as_tensor(inp["offsets"], device=device)
    n = offsets.numel() - 1
    counts = offsets[1:] - offsets[:-1]
    firm = torch.repeat_interleave(torch.arange(n, device=device), counts)
    within = torch.arange(int(offsets[-1]), device=device) - offsets[:-1][firm]
    ret = torch.as_tensor(inp["row_values"], device=device).to(dtype)
    day = torch.as_tensor(inp["row_pos"].astype(np.int64), device=device)
    month_of_day = torch.as_tensor(inp["day_month_id"].astype(np.int64), device=device)
    mkt_all = torch.as_tensor(inp["mkt"], device=device).to(dtype)
    mkt_ok_day = torch.as_tensor(inp["mkt_present"], device=device)

    # the annualized rolling standard deviation, on a (rows, firms) grid
    height = int(counts.max())
    grid = torch.full((height, n), float("nan"), dtype=dtype, device=device)
    grid[within, firm] = ret
    fin = torch.isfinite(grid)
    cnt_f = fin.sum(dim=0).clamp_min(1).to(dtype)
    centre = torch.where(fin, grid, 0.0).sum(dim=0) / cnt_f
    g = torch.where(fin, grid - centre, 0.0)
    s1 = _trailing(g, window)
    s2 = _trailing(g * g, window)
    cnt = _trailing(fin.to(dtype), window)
    var = ((s2 - s1 * s1 / cnt.clamp_min(1.0)) / (cnt - 1.0).clamp_min(1.0)).clamp_min(0.0)
    vol_grid = torch.where((cnt >= min_periods) & (cnt >= 2), torch.sqrt(var), float("nan"))
    vol_grid = vol_grid * math.sqrt(window)
    del g, s1, s2, cnt, var, fin, grid

    month = month_of_day[day]
    keep = month < t
    last = torch.full((t * n,), -1, dtype=torch.int64, device=device)
    last.scatter_reduce_(0, (month * n + firm)[keep], within[keep], reduce="amax")
    last = last.view(t, n)
    vol = torch.gather(vol_grid, 0, last.clamp_min(0))
    vol = torch.where(last >= 0, vol, float("nan"))
    del vol_grid

    # weekly sums of log returns, then 156-week forward windows
    n_weeks = int(inp["n_weeks"])
    week = torch.as_tensor(inp["week_id"].astype(np.int64), device=device)[day]
    mkt = mkt_all[day]
    present = mkt_ok_day[day]
    ri_ok = present & torch.isfinite(ret)
    rm_ok = present & torch.isfinite(mkt)
    lri = torch.where(ri_ok, torch.log1p(ret), 0.0)
    lrm = torch.where(rm_ok, torch.log1p(mkt), 0.0)
    in_range = (week >= 0) & (week < n_weeks)
    slot = (week * n + firm)[in_range]

    def weekly(v):
        acc = torch.zeros(n_weeks * n, dtype=dtype, device=device)
        acc.index_add_(0, slot, v[in_range].to(dtype))
        return acc.view(n_weeks, n)

    w_ri, w_rm = weekly(lri), weekly(lrm)
    w_rirm = weekly(torch.where(ri_ok & rm_ok, lri * lrm, 0.0))
    w_rm2 = weekly(lrm * lrm)
    w_cnt = weekly(present.to(dtype))
    w_rmcnt = weekly(rm_ok.to(dtype))
    del lri, lrm, mkt, present, ri_ok, rm_ok

    def forward(v):
        rev = torch.flip(torch.cumsum(torch.flip(v, (0,)), dim=0), (0,))  # Σ from w on
        tail = torch.cat([rev[window_weeks:], torch.zeros((window_weeks, n), dtype=dtype,
                                                          device=device)])[:n_weeks]
        return rev - tail

    s_ri, s_rm, s_rirm, s_rm2 = forward(w_ri), forward(w_rm), forward(w_rirm), forward(w_rm2)
    s_n, s_nrm = forward(w_cnt), forward(w_rmcnt)
    nn = s_n.clamp_min(1.0)
    beta_w = torch.where((s_n >= 2) & (s_nrm >= 1),
                         (s_rirm - s_ri * s_rm / nn) / (s_rm2 - s_rm * s_rm / nn), float("nan"))
    wk = torch.arange(n_weeks, device=device)[:, None]
    has = w_cnt > 0
    first = torch.where(has, wk, n_weeks).amin(dim=0)
    lastw = torch.where(has, wk, -1).amax(dim=0)
    ok = (wk >= first) & (wk <= lastw) & (s_n >= 1)
    wmonth = torch.as_tensor(inp["week_month_id"].astype(np.int64), device=device)
    wm = wmonth[:, None].expand(n_weeks, n)
    take = ok & (wm < t)
    lastwk = torch.full((t * n,), -1, dtype=torch.int64, device=device)
    firm_w = torch.arange(n, device=device)[None].expand(n_weeks, n)
    lastwk.scatter_reduce_(0, (wm * n + firm_w)[take], wk.expand(n_weeks, n)[take],
                           reduce="amax")
    lastwk = lastwk.view(t, n)
    beta = torch.gather(beta_w, 0, lastwk.clamp_min(0))
    beta = torch.where(lastwk >= 0, beta, float("nan"))
    return vol, beta


# -- the panel -----------------------------------------------------------------


def _quantiles(v: torch.Tensor, ok: torch.Tensor, qs):
    """Linear-interpolated quantiles of the ``ok`` entries of each row of
    ``v`` (..., N): a list of (...,) tensors, NaN where a row has none."""
    srt = torch.sort(torch.where(ok, v, float("inf")), dim=-1).values
    cnt = ok.sum(dim=-1)
    top = (cnt - 1).clamp_min(0)
    out = []
    for q in qs:
        rank = q * top.to(v.dtype)
        lo = torch.floor(rank).to(torch.int64)
        hi = torch.minimum(lo + 1, top)
        frac = rank - lo.to(v.dtype)
        val = (srt.gather(-1, lo[..., None])[..., 0] * (1.0 - frac)
               + srt.gather(-1, hi[..., None])[..., 0] * frac)
        out.append(torch.where(cnt > 0, val, float("nan")))
    return out


def build_panel(inp, dtype, device) -> Dict[str, torch.Tensor]:
    """The characteristics, winsorized, the base columns and the mask, each
    (T, N) in ``dtype``."""
    names = list(inp["var_names"])
    values = torch.as_tensor(inp["values"], device=device)
    mask = torch.as_tensor(inp["mask"], device=device)
    base = {nm: values[:, :, k].to(dtype) for k, nm in enumerate(names)}
    comp = {}
    pos = None
    for nm in ("retx", "prc", "shrout", "me", "be", "accruals", "depreciation", "earnings",
               "assets", "sales", "total_debt", "dvc"):
        comp[nm], pos = _compact(base[nm], mask)
    me1, be1 = _lag(comp["me"], 1), _lag(comp["be"], 1)
    shr1 = _lag(comp["shrout"], 1)
    chars = {
        "log_size": torch.log(me1),
        "log_bm": torch.log(be1) - torch.log(me1),
        "return_12_2": _roll_prod_full(1.0 + _lag(comp["retx"], 2), 11) - 1.0,
        "accruals_final": comp["accruals"] - comp["depreciation"],
        "roa": comp["earnings"] / comp["assets"],
        "log_assets_growth": torch.log(comp["assets"] / _lag(comp["assets"], 12)),
        "dy": _roll_sum(comp["dvc"], 12, 1) / _lag(comp["prc"], 1),
        "log_return_13_36": _roll_sum(_lag(torch.log1p(comp["retx"]), 13), 24, 24),
        "log_issues_12": torch.log(shr1) - torch.log(_lag(comp["shrout"], 12)),
        "log_issues_36": torch.log(shr1) - torch.log(_lag(comp["shrout"], 36)),
        "debt_price": comp["total_debt"] / me1,
        "sales_price": comp["sales"] / me1,
    }
    del comp
    panel = dict(base)
    for nm, c in chars.items():
        panel[nm] = _expand(c, mask, pos)
    del chars
    vol, beta = daily_characteristics(inp, dtype, device)
    panel["rolling_std_252"] = torch.where(mask, vol, float("nan"))
    panel["beta"] = torch.where(mask, beta, float("nan"))
    for nm in FACTORS.values():
        v = panel[nm]
        ok = mask & torch.isfinite(v)
        lo, hi = _quantiles(v, ok, (0.01, 0.99))
        clipped = torch.minimum(torch.maximum(v, lo[:, None]), hi[:, None])
        panel[nm] = torch.where((ok.sum(dim=1) >= 5)[:, None], clipped, v)
    panel["mask"] = mask
    return panel


def universes(panel, breakpoint_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The three universes. The breakpoints are interpolated in
    ``breakpoint_dtype``, the configuration's precision: membership is a
    discrete test, and a breakpoint rounded in float32 admits or drops a firm
    whose ME lies within that rounding of it, where float64 decides the other
    way; the rest of the reference runs in its own dtype."""
    mask = panel["mask"]
    me = panel["me"]
    nyse = mask & (panel["is_nyse"] > 0) & torch.isfinite(me)
    bp20, bp50 = (b.to(me.dtype) for b in _quantiles(me.to(breakpoint_dtype), nyse, (0.2, 0.5)))
    return {UNIVERSES[0]: mask, UNIVERSES[1]: mask & (me >= bp20[:, None]),
            UNIVERSES[2]: mask & (me >= bp50[:, None])}


def table_1(panel, unis) -> Dict[str, np.ndarray]:
    """Per universe: (avg (K,), std (K,), n (K,)) over FACTORS' columns, by
    contractions over the firms."""
    x = torch.stack([panel[c] for c in FACTORS.values()], dim=-1)   # (T, N, K)
    fin = torch.isfinite(x)
    xz = torch.where(fin, x, 0.0)
    finf = fin.to(x.dtype)
    out = {}
    for name, m in unis.items():
        mf = m.to(x.dtype)
        cnt = torch.einsum("tn,tnk->tk", mf, finf)
        mean = torch.einsum("tn,tnk->tk", mf, xz) / cnt.clamp_min(1.0)
        dev = torch.where(fin, x - mean[:, None, :], 0.0)
        ss = torch.einsum("tn,tnk->tk", mf, dev * dev)
        std = torch.sqrt(ss / (cnt - 1.0).clamp_min(1.0))
        has1, has2 = cnt >= 1, cnt >= 2
        avg = torch.where(has1, mean, 0.0).sum(0) / has1.sum(0).clamp_min(1)
        sd = torch.where(has2, std, 0.0).sum(0) / has2.sum(0).clamp_min(1)
        ever = ((m[..., None] & fin).any(dim=0)).sum(dim=0)
        out[name] = (avg.cpu().numpy(), sd.cpu().numpy(), ever.cpu().numpy())
        del dev
    return out


def _roll_valid_rows(series: torch.Tensor, valid: torch.Tensor, window: int,
                     min_periods: int, row_lag: int = 0, fill: bool = False) -> torch.Tensor:
    """Rolling mean of ``series`` (T, K) over its ``valid`` (T,) rows, taken
    as consecutive; lagged ``row_lag`` rows; placed at the valid months
    (NaN elsewhere), or with ``fill`` at every month from the last valid row
    before it."""
    idx = torch.nonzero(valid)[:, 0]
    rolled = _roll_mean(series[idx], window, min_periods)
    if row_lag:
        rolled = _lag(rolled, row_lag)
    out = torch.full_like(series, float("nan"))
    if not fill:
        out[idx] = rolled
        return out
    # the lagged mean a month sees: the window ending at the last valid row
    # strictly before it (row_lag = 1), so row k of the lagged series
    before = torch.cumsum(valid.to(torch.int64), dim=0) - valid.to(torch.int64)
    unlagged = _roll_mean(series[idx], window, min_periods)
    pick = before - 1
    got = unlagged[pick.clamp_min(0)]
    return torch.where((pick >= 0)[:, None], got, float("nan"))


def decile_sorts(er, er_ok, ret, n_dec: int = 10, min_obs: int = 50, nw_lags: int = 4):
    from portbench.reference.fm import nw_se

    ok = er_ok & torch.isfinite(ret)
    n = ok.sum(dim=1)
    month_ok = n >= min_obs
    breaks = torch.stack(_quantiles(er, ok, [d / n_dec for d in range(1, n_dec)]), dim=1)
    dec = (torch.where(ok, er, 0.0)[:, :, None] > breaks[:, None, :]).sum(dim=-1)
    counts, sums = [], []
    for d in range(n_dec):
        ind = ok & (dec == d)
        counts.append(ind.sum(dim=1).to(er.dtype))
        sums.append(torch.where(ind, ret, 0.0).sum(dim=1))
    counts, sums = torch.stack(counts, 1), torch.stack(sums, 1)
    dret = torch.where((counts > 0) & month_ok[:, None], sums / counts.clamp_min(1.0),
                       float("nan"))
    usable = month_ok & (counts > 0).all(dim=1)
    mean_ret = dret[usable].mean(dim=0)
    spread_s = dret[:, -1] - dret[:, 0]
    sv = usable & torch.isfinite(spread_s)
    spread = spread_s[sv].mean()
    se = nw_se(spread_s[:, None], sv[:, None], nw_lags)[0]
    return {"mean_returns": mean_ret.cpu().numpy(), "spread": float(spread),
            "spread_tstat": float(spread / se), "n_months": int(sv.sum())}


def replicate(inp, dtype=torch.float64, device="cuda",
              breakpoint_dtype=torch.float32) -> Dict[str, object]:
    """Every output of the main path that the benchmark compares, on the
    host: the panel's published columns, the universes, Table 1, Table 2,
    Figure 1, the decile sorts and the serving state's coefficients."""
    panel = build_panel(inp, dtype, device)
    unis = universes(panel, breakpoint_dtype)
    out: Dict[str, object] = {
        "columns": {c: panel[c].cpu().numpy() for c in FACTORS.values()},
        "universes": {k: v.cpu().numpy() for k, v in unis.items()},
        "table_1": table_1(panel, unis),
    }
    y = panel["retx"]
    t2 = {}
    for model, cols in MODELS.items():
        x = torch.stack([panel[c] for c in cols], dim=-1)
        for uni in UNIVERSES:
            t2[(model, uni)] = fm_summary(monthly_cs(y, x, unis[uni], dtype=dtype))
        del x
    out["table_2"] = t2
    xf = torch.stack([panel[c] for c in FIGURE_VARS], dim=-1)
    figure, deciles = {}, {}
    for uni in UNIVERSES:
        cs = monthly_cs(y, xf, unis[uni], dtype=dtype)
        if uni in ("All stocks", "Large stocks"):
            rolled = _roll_valid_rows(cs.slopes, cs.month_valid, 120, 60)
            figure[uni] = rolled[cs.month_valid].cpu().numpy()
        coefs = torch.cat([cs.intercept[:, None], cs.slopes], dim=1)
        bar = _roll_valid_rows(coefs, cs.month_valid, 120, 60, row_lag=1)
        rows = unis[uni] & torch.isfinite(y) & torch.isfinite(xf).all(dim=-1)
        have = torch.isfinite(bar).all(dim=1)
        er = bar[:, 0][:, None] + torch.einsum("tnp,tp->tn", torch.where(rows[..., None], xf, 0.0),
                                               torch.nan_to_num(bar[:, 1:]))
        er_ok = rows & have[:, None]
        deciles[uni] = decile_sorts(torch.where(er_ok, er, float("nan")), er_ok, y)
        if uni == "All stocks":
            out["serving"] = _roll_valid_rows(coefs, cs.month_valid, 120, 60, row_lag=1,
                                              fill=True).cpu().numpy()
    out["figure_1"] = figure
    out["deciles"] = deciles
    return out
