"""Rolling out-of-sample expected-return forecasts and decile sorts.

The out-of-sample half of Lewellen (2015): at month t, average the previous
``window`` months of Fama-MacBeth slopes (minimum ``min_periods``; STRICTLY
past months — the rolling mean is lagged one result row), project
``Ê[r]_{i,t} = ā + b̄' X_{i,t}`` for every firm with complete predictors,
sort the cross-section into deciles on the forecast, and track each
decile's realized equal-weighted return, plus the 10−1 spread with its
Newey-West t-statistic.

Batched monthly OLS → compacted rolling slope means
(``ops.compaction.rolling_over_valid_rows``, the rolling kernel's mean) →
masked decile breakpoints (batched sort) → per-decile masked sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fm_returnprediction_tpu_torch.ops.compaction import rolling_over_valid_rows
from fm_returnprediction_tpu_torch.ops.newey_west import nw_mean_se
from fm_returnprediction_tpu_torch.ops.ols import (
    NormalStats,
    monthly_cs_ols,
    row_validity,
    sufficient_stats,
)
from fm_returnprediction_tpu_torch.ops.quantiles import masked_quantile

__all__ = [
    "ForecastResult",
    "ForecastArtifacts",
    "DecileSortResult",
    "rolling_er_forecast",
    "fit_forecast_artifacts",
    "decile_sorts",
]


class ForecastResult(NamedTuple):
    er: torch.Tensor             # (T, N) out-of-sample E[r]; NaN where unavailable
    er_valid: torch.Tensor       # (T, N) bool
    slopes_bar: torch.Tensor     # (T, P) lagged rolling mean slopes (NaN-gated)
    intercept_bar: torch.Tensor  # (T,)


class ForecastArtifacts(NamedTuple):
    """The fitted quantities the serving state persists: per-month
    coefficients, their lagged rolling means, and the ADDITIVE
    normal-equation sufficient statistics."""

    coef: torch.Tensor           # (T, Q) per-month [intercept, slopes]
    month_valid: torch.Tensor    # (T,) bool: month had >= Q valid rows
    slopes_bar: torch.Tensor     # (T, P) lagged rolling mean slopes (NaN-gated)
    intercept_bar: torch.Tensor  # (T,)
    stats: NormalStats           # (T, ...) additive per-month sufficient stats


class DecileSortResult(NamedTuple):
    decile_returns: torch.Tensor  # (T, D) equal-weighted realized return per decile
    decile_counts: torch.Tensor   # (T, D)
    month_valid: torch.Tensor     # (T,) months with a usable forecast cross-section
    mean_returns: torch.Tensor    # (D,) time-series mean per decile
    spread: torch.Tensor          # () mean top-minus-bottom decile return
    spread_tstat: torch.Tensor    # () spread / NW SE
    n_months: torch.Tensor        # ()


def _lagged_coef_means(cs, window: int, min_periods: int,
                       fill_invalid: bool = False):
    """Per-month [intercept, slopes] rows and their LAGGED rolling means
    over consecutive surviving months, shifted one row so month t sees only
    strictly-prior estimates. ``fill_invalid=True`` (the serving state)
    also fills months whose own cross-section produced no row."""
    coefs = torch.cat([cs.intercept[:, None], cs.slopes], dim=1)  # (T, Q)
    bar = rolling_over_valid_rows(coefs, cs.month_valid, window, min_periods,
                                  row_lag=1, fill_invalid=fill_invalid)
    return coefs, bar


def fit_forecast_artifacts(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                           window: int = 120, min_periods: int = 60,
                           solver: str = "qr", cs=None) -> ForecastArtifacts:
    """Everything ``serving.state.ServingState`` persists.

    Same inputs and conventions as :func:`rolling_er_forecast` (pass
    ``cs`` to reuse a precomputed batched OLS, else ``solver`` picks the
    per-month OLS solver); additionally contracts the
    panel into per-month normal-equation sufficient statistics. The lagged
    means are the ``fill_invalid`` variant, a deliberate superset of the
    batch forecast's coverage.
    """
    if cs is None:
        cs = monthly_cs_ols(y, x, mask, record=False, solver=solver)
    coefs, bar = _lagged_coef_means(cs, window, min_periods, fill_invalid=True)
    stats = sufficient_stats(y, x, row_validity(y, x, mask))
    return ForecastArtifacts(coefs, cs.month_valid, bar[:, 1:], bar[:, 0], stats)


def rolling_er_forecast(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                        window: int = 120, min_periods: int = 60,
                        solver: str = "qr", cs=None) -> ForecastResult:
    """Strictly out-of-sample Ê[r] from lagged rolling FM coefficients.

    y (T, N), x (T, N, P) LAGGED characteristics, mask (T, N) bool. Pass a
    precomputed ``cs`` (``CSRegressionResult`` tensors on y's device for
    exactly these inputs) to reuse an earlier batched OLS; otherwise
    ``solver`` (``"qr"``, ``"lstsq"`` or ``"normal"``) fits it.
    """
    if cs is None:
        cs = monthly_cs_ols(y, x, mask, record=False, solver=solver)
    _, bar = _lagged_coef_means(cs, window, min_periods)
    intercept_bar = bar[:, 0]
    slopes_bar = bar[:, 1:]

    rows = row_validity(y, x, mask)  # the forecast needs complete predictors
    have_coef = torch.isfinite(intercept_bar) & torch.isfinite(slopes_bar).all(dim=1)
    xz = torch.where(rows[..., None], x, torch.zeros_like(x))
    er = intercept_bar[:, None] + torch.einsum("tnp,tp->tn", xz, slopes_bar)
    er_valid = rows & have_coef[:, None]
    er = torch.where(er_valid, er, torch.full_like(er, float("nan")))
    return ForecastResult(er, er_valid, slopes_bar, intercept_bar)


def decile_sorts(er: torch.Tensor, er_valid: torch.Tensor, realized: torch.Tensor,
                 n_deciles: int = 10, min_obs: int = 50, nw_lags: int = 4,
                 weight: str = "reference") -> DecileSortResult:
    """Monthly decile portfolios on the forecast, realized-return averages.

    er, er_valid, realized: (T, N). A month participates when it has at
    least ``min_obs`` firms with a forecast AND a realized return.
    Breakpoints are the masked 10th..90th percentiles (linear); decile d
    spans (q_d, q_{d+1}], i.e. the decile index is the count of interior
    breakpoints strictly below ``er``.
    """
    dtype = er.dtype
    ok = er_valid & torch.isfinite(realized)
    n = ok.sum(dim=1)
    month_valid = n >= min_obs

    breaks = masked_quantile(er, ok, [d / n_deciles for d in range(1, n_deciles)])
    er_z = torch.where(ok, er, torch.zeros_like(er))
    dec = (er_z[:, :, None] > breaks[:, None, :]).sum(dim=-1)   # (T, N) in [0, D-1]

    # Per-decile masked sums, one (T, N) pass per decile: deterministic (no
    # atomics, unlike index_add_/scatter_add_ on the card) and never builds
    # the (T, N, D) one-hot (int64 from F.one_hot, ~1 GB at 600 × 22,000).
    ret_z = torch.where(ok, realized, torch.zeros_like(realized))
    counts, sums = [], []
    for d in range(n_deciles):
        in_d = ok & (dec == d)
        counts.append(in_d.sum(dim=1).to(dtype))
        sums.append(torch.where(in_d, ret_z, torch.zeros_like(ret_z)).sum(dim=1))
    counts = torch.stack(counts, dim=1)                         # (T, D)
    sums = torch.stack(sums, dim=1)
    nan = float("nan")
    dec_ret = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                          torch.full_like(sums, nan))
    dec_ret = torch.where(month_valid[:, None], dec_ret, torch.full_like(dec_ret, nan))

    # summary statistics use months where EVERY decile is populated, so the
    # 10−1 spread and per-decile means cover the same months
    usable = month_valid & (counts > 0).all(dim=1)
    n_usable = usable.sum()
    kept = torch.where(usable[:, None], torch.nan_to_num(dec_ret),
                       torch.zeros_like(dec_ret))
    mean_ret = kept.sum(dim=0) / torch.clamp_min(n_usable, 1).to(dtype)
    mean_ret = torch.where(n_usable > 0, mean_ret, torch.full_like(mean_ret, nan))
    spread_series = dec_ret[:, -1] - dec_ret[:, 0]
    spread_valid = usable & torch.isfinite(spread_series)
    n_spread = spread_valid.sum()
    spread = (torch.where(spread_valid, spread_series,
                          torch.zeros_like(spread_series)).sum()
              / torch.clamp_min(n_spread, 1).to(dtype))
    spread = torch.where(n_spread > 0, spread, torch.full_like(spread, nan))
    se = nw_mean_se(spread_series, spread_valid, lags=nw_lags, weight=weight)
    return DecileSortResult(dec_ret, counts, month_valid, mean_ret, spread,
                            spread / se, n_spread)
