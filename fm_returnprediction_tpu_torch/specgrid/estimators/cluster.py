"""Clustered / robust SE families: the pooled-OLS sandwich and the
clustered Fama-MacBeth aggregation.

Two places a clustered SE enters the estimator family:

1. **FM kinds** (``se="cluster"``): the FM point estimate is a mean of
   monthly slopes, so its clustered SE is the clustered variance of a
   time-series mean, by calendar-YEAR blocks (``month // 12``,
   ``ops.newey_west.clustered_mean_se``). :func:`fm_cluster_summary` is
   ``fama_macbeth_summary`` with that kernel in place of Newey-West (the
   same dropna / min-months / mean semantics).

2. **Pooled kind**: one β per cell from the MONTH-SUMMED Grams, with a
   sandwich variance ``V = B·meat·B`` (``B`` = bread, the pooled Gram
   pinv). The per-month stats are CENTERED (x̃ = x − c_t, a different c_t
   each month), so they are first de-centered exactly:

       G_raw[j,k] = G̃[j,k] + c_j G̃[0,k] + c_k G̃[0,j] + n c_j c_k
       m_raw[j]   = m̃[j] + c_j·ysum

   (:func:`decentered_stats`); their month sum is the pooled raw-basis
   Gram. Meats:

   - ``iid``           — σ²·B with σ² = SSE/(n − q);
   - ``cluster_month`` — Σ_t s_t s_t' over per-month score sums
     ``s_t = m_t − G_t β``: Gram algebra only, which is why the Gram bank
     serves it without the panel;
   - ``cluster_firm``  — Σ_i s_i s_i' over per-firm score sums
     ``s_i = Σ_t w x u``: one residual pass, never an (N, Q, Q) tensor;
   - ``white``         — Σ w u² x x' (heteroskedasticity-robust);
   - ``cluster_twoway``— CGM inclusion-exclusion: month + firm − white.

   No small-sample correction is applied to any meat.

Firm/White meats read the panel (:func:`pooled_panel_meats`, one spec at a
time so one spec's (T, N, P) design is the peak, with the White meat's
cross products one product of the weighted design); month/iid meats are
sufficient statistics only — the split that decides which pooled SE
families ``grambank.estimator_query`` accepts.

Everything here is plain torch: the reference computes it with einsum and
``segment_sum`` outside any Pallas kernel. On the card the only kernel on
an estimator path is the Gram contraction that made the stats (K2,
``grams.contract_spec_grams``).

Precision: the sums run at the stats' dtype. A float32 panel's pooled fit
sums 600 months of de-centered raw-basis float32 Grams and solves them in
float32, where the reference, under its x64 flag, solves float64; the port's
float32 pooled ``coef``/``se`` therefore carry float32 rounding of the
month sum (the gap to a float64 run of the same panel is measured on the
card, ``PERF.md``). Parity with the reference is held at float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fm_returnprediction_tpu_torch.ops.fama_macbeth import FamaMacbethSummary
from fm_returnprediction_tpu_torch.ops.newey_west import clustered_mean_se
from fm_returnprediction_tpu_torch.specgrid.estimators.core import (
    POOLED_SE_FAMILIES,
    masked_psd_solve,
)

__all__ = [
    "PooledResult",
    "BANK_POOLED_SE",
    "fm_cluster_summary",
    "decentered_stats",
    "pooled_fit",
    "pooled_panel_meats",
]

#: pooled SE families computable from the per-month stats alone (no panel)
BANK_POOLED_SE = ("iid", "cluster_month")

#: pooled SE families whose meat reads the panel
PANEL_POOLED_SE = ("cluster_firm", "white", "cluster_twoway")


class PooledResult(NamedTuple):
    """Pooled-OLS leaves, spec-major (tensors)."""

    beta: torch.Tensor       # (S, Q) raw-basis, intercept first
    se: torch.Tensor         # (S, Q) sandwich SE, selected cols
    tstat: torch.Tensor      # (S, Q)
    r2: torch.Tensor         # (S,) pooled R²
    n_total: torch.Tensor    # (S,) pooled row count
    n_months: torch.Tensor   # (S,) months contributing rows
    deficient: torch.Tensor  # (S,) bool: pooled Gram lost rank


def fm_cluster_summary(cs, min_months: int, cluster_months: int = 12) -> FamaMacbethSummary:
    """``fama_macbeth_summary`` with the by-year clustered SE kernel in
    place of Newey-West, the FM kinds' ``se="cluster"`` aggregation. Leaves
    may carry leading batch axes (slopes (..., T, P), the rest (..., T)).
    Cluster ids are CALENDAR ``t // cluster_months``: clusters follow the
    calendar even where interior months dropped out."""
    dtype = cs.slopes.dtype
    nan = float("nan")
    month_valid = cs.month_valid
    n_months = month_valid.sum(dim=-1)
    slope_valid = month_valid[..., None] & torch.isfinite(cs.slopes)
    count = slope_valid.sum(dim=-2)
    slopes_z = torch.where(slope_valid, cs.slopes, torch.zeros_like(cs.slopes))
    mean_slope = slopes_z.sum(dim=-2) / torch.clamp_min(count, 1).to(dtype)
    t = cs.slopes.shape[-2]
    ids = torch.arange(t, device=cs.slopes.device) // cluster_months
    se = clustered_mean_se(cs.slopes.transpose(-1, -2), slope_valid.transpose(-1, -2), ids)
    enough = count >= min_months
    coef = torch.where(enough, mean_slope, torch.full_like(mean_slope, nan))
    tstat = torch.where(enough, mean_slope / se, torch.full_like(mean_slope, nan))
    r2 = cs.r2
    r2_valid = month_valid & torch.isfinite(r2)
    r2_count = r2_valid.sum(dim=-1)
    r2_sum = torch.where(r2_valid, r2, torch.zeros_like(r2)).sum(dim=-1)
    mean_r2 = torch.where(r2_count > 0, r2_sum / torch.clamp_min(r2_count, 1).to(r2.dtype),
                          torch.full_like(r2_sum, nan))
    mf = month_valid.to(r2.dtype)
    n_sum = (cs.n_obs.to(r2.dtype) * mf).sum(dim=-1)
    mean_n = torch.where(n_months > 0, n_sum / torch.clamp_min(n_months, 1).to(r2.dtype),
                         torch.full_like(n_sum, nan))
    return FamaMacbethSummary(coef, tstat, se, mean_r2, mean_n, n_months)


def decentered_stats(stats, sel_aug: torch.Tensor):
    """Exact raw-basis per-month Gram/moment from the centered stats
    (selection-masked, so NaN-bearing unselected entries never leak).
    Returns ``(g_raw (S, T, Q, Q), m_raw (S, T, Q))``."""
    zero = torch.zeros((), dtype=stats.gram.dtype, device=stats.gram.device)
    sel2 = sel_aug[:, None, :, None] & sel_aug[:, None, None, :]
    g = torch.where(sel2, stats.gram, zero)
    m = torch.where(sel_aug[:, None, :], stats.moment, zero)
    caug = torch.cat([torch.zeros_like(stats.center[:, :1]), stats.center], dim=-1)  # (T, Q)
    c = torch.where(sel_aug[:, None, :], caug[None], zero)                          # (S, T, Q)
    row0 = g[..., 0, :]                                                              # (S, T, Q)
    g_raw = (g + c[..., :, None] * row0[..., None, :] + c[..., None, :] * row0[..., :, None]
             + stats.n[..., None, None] * c[..., :, None] * c[..., None, :])
    m_raw = m + c * stats.ysum[..., None]
    return g_raw, m_raw


def pooled_fit(stats, sel_aug: torch.Tensor, se: str, data_eps: float, panel=None,
               row_weights=None) -> PooledResult:
    """Pooled OLS + sandwich over the month-summed de-centered Grams.

    ``se`` ∈ ``POOLED_SE_FAMILIES``; the panel-borne meats
    (``cluster_firm``/``white``/``cluster_twoway``) need ``panel`` =
    ``(y, x, universes, uidx, col_sel, window)`` for the one residual pass
    (:func:`pooled_panel_meats`); stats-only callers (the Gram bank) are
    restricted to :data:`BANK_POOLED_SE` and pass none."""
    if se not in POOLED_SE_FAMILIES:
        raise ValueError(f"pooled se must be one of {POOLED_SE_FAMILIES}, got {se!r}")
    needs_panel = se in PANEL_POOLED_SE
    if needs_panel and panel is None:
        raise ValueError(
            f"pooled se={se!r} needs the panel for its meat (pooled_panel_meats) — "
            f"stats-only routes serve only {BANK_POOLED_SE}")
    g_raw, m_raw = decentered_stats(stats, sel_aug)
    g_pool = g_raw.sum(1)                                   # (S, Q, Q)
    m_pool = m_raw.sum(1)                                   # (S, Q)
    n_tot = stats.n.sum(1)
    ysum_tot = stats.ysum.sum(1)
    yy_tot = stats.yy.sum(1)
    dtype = g_pool.dtype
    q = g_pool.shape[-1]

    eye = torch.eye(q, dtype=dtype, device=g_pool.device).expand(g_pool.shape)
    rhs = torch.cat([m_pool[..., None], eye], dim=-1)
    sol, deficient = masked_psd_solve(g_pool, sel_aug, rhs, data_eps)
    beta = sol[..., 0]                                      # (S, Q)
    bread = sol[..., 1:]                                    # (S, Q, Q) ≈ G⁻¹

    bg = torch.einsum("sq,sqr,sr->s", beta, g_pool, beta)
    bm = torch.einsum("sq,sq->s", beta, m_pool)
    sse = yy_tot - 2.0 * bm + bg
    sst = yy_tot - ysum_tot * ysum_tot / torch.clamp_min(n_tot, 1.0)
    r2 = torch.where(sst > 0, 1.0 - sse / torch.where(sst > 0, sst, torch.ones_like(sst)),
                     torch.full_like(sst, float("nan")))

    q_s = sel_aug.sum(-1).to(dtype)
    if se == "iid":
        sigma2 = sse / torch.clamp_min(n_tot - q_s, 1.0)
        cov = sigma2[:, None, None] * bread
    else:
        meat_firm = meat_white = None
        if needs_panel:
            meat_firm, meat_white = pooled_panel_meats(*panel, beta, row_weights=row_weights)
        if se in ("cluster_month", "cluster_twoway"):
            s_t = m_raw - torch.einsum("stqr,sr->stq", g_raw, beta)
            meat_month = torch.einsum("stq,str->sqr", s_t, s_t)
        if se == "cluster_month":
            meat = meat_month
        elif se == "cluster_firm":
            meat = meat_firm
        elif se == "white":
            meat = meat_white
        else:  # cluster_twoway — CGM inclusion-exclusion
            meat = meat_month + meat_firm - meat_white
        cov = bread @ meat @ bread
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    nan = torch.full_like(var, float("nan"))
    se_vec = torch.where(sel_aug, torch.sqrt(torch.clamp_min(var, 0.0)), nan)
    beta_out = torch.where(sel_aug, beta, nan)
    return PooledResult(
        beta=beta_out, se=se_vec, tstat=beta_out / se_vec, r2=r2, n_total=n_tot,
        n_months=(stats.n > 0).sum(1), deficient=deficient,
    )


def pooled_panel_meats(y, x, universes, uidx, col_sel, window, beta, row_weights=None):
    """The panel-borne sandwich meats of the pooled kind: per-firm score
    outer products (``cluster_firm``) and the White meat, in one residual
    pass per spec. ``beta`` (S, Q) is the raw-basis pooled solution;
    ``window`` the per-spec (S, T) month mask; ``row_weights`` the coreset
    route's (T, N) importance weighting. Row validity is the contraction's
    own rule, so the score sums match the pooled Gram exactly. Returns
    ``(meat_firm (S, Q, Q), meat_white (S, Q, Q))``."""
    x_fin = torch.isfinite(x)
    y_fin = torch.isfinite(y)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_z = torch.where(x_fin, x, zero)
    y_z = torch.where(y_fin, y, zero)
    firm, white = [], []
    for s in range(col_sel.shape[0]):
        sel, b = col_sel[s], beta[s]
        valid = (y_fin & window[s][:, None] & universes[uidx[s]]
                 & torch.all(x_fin | ~sel, dim=-1))
        w = valid.to(x.dtype)                               # (T, N)
        if row_weights is not None:
            w = w * row_weights
        xs = torch.where(sel, x_z, zero)                    # (T, N, P)
        u = y_z - b[0] - xs @ b[1:]
        wu = w * u
        # s_i = Σ_t w x u — per-firm scores without an (N, Q, Q) tensor
        s_firm = torch.cat([wu.sum(0)[:, None], (xs * wu[..., None]).sum(0)], dim=-1)
        firm.append(s_firm.T @ s_firm)
        wu2 = wu * u
        xw = xs * wu2[..., None]
        flat = xs.reshape(-1, xs.shape[-1])
        mw_xx = xw.reshape(-1, xs.shape[-1]).T @ flat       # one product of the weighted design
        mw_x0 = xw.sum(dim=(0, 1))
        top = torch.cat([wu2.sum()[None], mw_x0])[None, :]
        white.append(torch.cat([top, torch.cat([mw_x0[:, None], mw_xx], dim=-1)], dim=0))
        del xs, xw, flat
    return torch.stack(firm), torch.stack(white)
