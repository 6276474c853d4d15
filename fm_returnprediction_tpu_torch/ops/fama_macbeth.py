"""Fama-MacBeth aggregation of monthly cross-sectional regressions.

- mean slope per predictor over the months whose regression ran AND whose
  slope is finite (the reference's per-column ``.dropna()``);
- predictors with fewer than ``min_months`` valid months report NaN
  coefficient and t-stat;
- t-stat = mean / NW-SE with the reference's ``1 − k/n`` weight;
- mean R² and mean N over the months that ran.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fm_returnprediction_tpu_torch.ops.newey_west import nw_mean_se
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult, monthly_cs_ols

__all__ = ["FamaMacbethSummary", "fama_macbeth_summary", "fama_macbeth"]


class FamaMacbethSummary(NamedTuple):
    coef: torch.Tensor      # (..., P) mean slope per predictor
    tstat: torch.Tensor     # (..., P) mean / NW-SE
    nw_se: torch.Tensor     # (..., P) NW standard error of the mean slope
    mean_r2: torch.Tensor   # (...) mean cross-sectional R² over run months
    mean_n: torch.Tensor    # (...) mean per-month N over run months
    n_months: torch.Tensor  # (...) number of months that ran


def fama_macbeth_summary(cs: CSRegressionResult, nw_lags: int = 4,
                         min_months: int = 10,
                         weight: str = "reference") -> FamaMacbethSummary:
    """Aggregate a batched cross-sectional result. Leaves may carry leading
    batch axes (a spec axis): slopes (..., T, P), the rest (..., T)."""
    dtype = cs.slopes.dtype
    month_valid = cs.month_valid
    mf = month_valid.to(dtype)
    n_months = month_valid.sum(dim=-1)
    nan = float("nan")

    slope_valid = month_valid[..., None] & torch.isfinite(cs.slopes)
    count = slope_valid.sum(dim=-2)
    slopes_z = torch.where(slope_valid, cs.slopes, torch.zeros_like(cs.slopes))
    mean_slope = slopes_z.sum(dim=-2) / torch.clamp_min(count, 1).to(dtype)
    se = nw_mean_se(cs.slopes.transpose(-1, -2), slope_valid.transpose(-1, -2),
                    lags=nw_lags, weight=weight)

    enough = count >= min_months
    coef = torch.where(enough, mean_slope, torch.full_like(mean_slope, nan))
    tstat = torch.where(enough, mean_slope / se, torch.full_like(mean_slope, nan))

    r2 = cs.r2
    r2_valid = month_valid & torch.isfinite(r2)
    r2_count = r2_valid.sum(dim=-1)
    r2_sum = torch.where(r2_valid, r2, torch.zeros_like(r2)).sum(dim=-1)
    mean_r2 = torch.where(r2_count > 0,
                          r2_sum / torch.clamp_min(r2_count, 1).to(r2.dtype),
                          torch.full_like(r2_sum, nan))
    n_sum = (cs.n_obs.to(r2.dtype) * mf).sum(dim=-1)
    mean_n = torch.where(n_months > 0,
                         n_sum / torch.clamp_min(n_months, 1).to(r2.dtype),
                         torch.full_like(n_sum, nan))
    return FamaMacbethSummary(coef, tstat, se, mean_r2, mean_n, n_months)


def fama_macbeth(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                 nw_lags: int = 4, min_months: int = 10,
                 weight: str = "reference"):
    """End-to-end FM: batched monthly QR OLS + aggregation."""
    cs = monthly_cs_ols(y, x, mask)
    fm = fama_macbeth_summary(cs, nw_lags=nw_lags, min_months=min_months,
                              weight=weight)
    return cs, fm
