"""Per-month quantile portfolios on predicted E[r] — EW/VW, spread,
turnover.

Sort each month's cross-section into ``n_quantiles`` buckets on the
out-of-sample forecast, track each bucket's realized return under equal or
value weights, the top-minus-bottom spread with its Newey-West t-stat, and
one-way turnover. Conventions, as in the JAX package:

- breakpoints are the masked interior percentiles
  (``ops.quantiles.masked_quantile``, pandas-linear interpolation);
- assignment is TIE-DETERMINISTIC: bucket = number of breakpoints STRICTLY
  below the forecast, so equal forecasts share a bucket whatever the firm
  order or device;
- a month participates with at least ``min_obs`` sortable firms; summary
  statistics use months where EVERY bucket is populated;
- value weights are the supplied per-firm weight (market equity in the
  pipeline); a non-finite or non-positive weight drops the firm;
- one-way turnover of bucket d at month t is ``½ Σ_i |w_{t,i,d} −
  w_{t−1,i,d}|`` over the bucket's NORMALIZED weights, defined when t and
  t−1 are both valid with the bucket populated; ``spread_turnover`` is the
  mean of the two legs' turnovers.

The sorts run where the tensors lie; the bucket comparison is one (T, N,
D−1) boolean tensor, each bucket then one (T, N) slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fm_returnprediction_tpu_torch.ops.newey_west import nw_mean_se
from fm_returnprediction_tpu_torch.ops.quantiles import masked_quantile

__all__ = ["PortfolioResult", "quantile_sorts"]


class PortfolioResult(NamedTuple):
    quantile_returns: torch.Tensor  # (T, D) realized return per bucket
    counts: torch.Tensor            # (T, D) firms per bucket
    month_valid: torch.Tensor       # (T,) months with a sortable section
    mean_returns: torch.Tensor      # (D,) time-series mean per bucket
    spread_series: torch.Tensor     # (T,) top − bottom realized return
    spread: torch.Tensor            # () mean spread
    spread_tstat: torch.Tensor      # () spread / NW SE
    spread_nw_se: torch.Tensor      # ()
    turnover: torch.Tensor          # (T, D) one-way turnover per bucket
    spread_turnover: torch.Tensor   # (T,) mean of the two legs' turnovers
    n_months: torch.Tensor          # () months in the summary statistics


def quantile_sorts(
    er: torch.Tensor,
    er_valid: torch.Tensor,
    realized: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    n_quantiles: int = 10,
    min_obs: int = 50,
    nw_lags: int = 4,
    nw_weight: str = "reference",
    value_weighted: bool = False,
) -> PortfolioResult:
    """Monthly quantile portfolios on the forecast. ``er``/``er_valid``/
    ``realized`` are (T, N) tensors; ``weights`` is the (T, N) value-weight
    variable, read only under ``value_weighted=True``."""
    dtype = er.dtype
    zero = torch.zeros((), dtype=dtype, device=er.device)
    nan = float("nan")
    ok = er_valid & torch.isfinite(realized)
    if value_weighted:
        ok = ok & torch.isfinite(weights) & (weights > 0)
        wv = torch.where(ok, weights.to(dtype), zero)
    else:
        wv = ok.to(dtype)
    month_valid = ok.sum(dim=1) >= min_obs

    breaks = masked_quantile(er, ok, [d / n_quantiles for d in range(1, n_quantiles)])
    # bucket = number of interior breakpoints STRICTLY below the forecast
    er_z = torch.where(ok, er, zero)
    bucket = (er_z[:, :, None] > breaks[:, None, :]).sum(dim=-1)          # (T, N)

    ret_z = torch.where(ok, realized, zero)
    first = torch.zeros((1,), dtype=torch.bool, device=er.device)
    qret_cols, cnt_cols, tau_cols = [], [], []
    for d in range(n_quantiles):
        sel = (bucket == d) & ok
        wd = torch.where(sel, wv, zero)                                     # (T, N)
        sw = wd.sum(dim=1)
        cnt = sel.sum(dim=1)
        sums = (wd * ret_z).sum(dim=1)
        denom = torch.where(sw > 0, sw, torch.ones_like(sw))
        qret = torch.where(sw > 0, sums / denom, torch.full_like(sums, nan))
        # normalized holdings → one-way turnover against last month
        wnorm = wd / denom[:, None]
        tau = torch.cat([torch.full((1,), nan, dtype=dtype, device=er.device),
                         0.5 * torch.abs(wnorm[1:] - wnorm[:-1]).sum(dim=1)])
        both = torch.cat([first, month_valid[1:] & month_valid[:-1]
                          & (cnt[1:] > 0) & (cnt[:-1] > 0)])
        qret_cols.append(torch.where(month_valid, qret, torch.full_like(qret, nan)))
        cnt_cols.append(cnt)
        tau_cols.append(torch.where(both, tau, torch.full_like(tau, nan)))
    qret = torch.stack(qret_cols, dim=1)                                   # (T, D)
    counts = torch.stack(cnt_cols, dim=1)
    turnover = torch.stack(tau_cols, dim=1)

    # summary over months where EVERY bucket is populated
    usable = month_valid & torch.all(counts > 0, dim=1)
    n_use = usable.sum()
    mean_ret = torch.where(
        n_use > 0,
        torch.where(usable[:, None], torch.nan_to_num(qret), zero).sum(dim=0)
        / torch.clamp_min(n_use, 1).to(dtype),
        torch.full((n_quantiles,), nan, dtype=dtype, device=er.device))
    spread_series = qret[:, -1] - qret[:, 0]
    spread_valid = usable & torch.isfinite(spread_series)
    n_spread = spread_valid.sum()
    spread = torch.where(
        n_spread > 0,
        torch.where(spread_valid, spread_series, zero).sum()
        / torch.clamp_min(n_spread, 1).to(dtype),
        torch.full((), nan, dtype=dtype, device=er.device))
    se = nw_mean_se(spread_series, spread_valid, lags=nw_lags, weight=nw_weight)
    return PortfolioResult(
        quantile_returns=qret, counts=counts, month_valid=month_valid, mean_returns=mean_ret,
        spread_series=spread_series, spread=spread, spread_tstat=spread / se,
        spread_nw_se=se, turnover=turnover,
        spread_turnover=0.5 * (turnover[:, -1] + turnover[:, 0]), n_months=n_spread)
