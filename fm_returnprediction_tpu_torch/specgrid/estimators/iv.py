"""IV/2SLS as two Gram solves over an instrument block.

2SLS solves ``X̂'X̂ β = X̂'y`` with ``X̂ = P_Z X``, and every entry of that
projected system is a quadratic form in the month's augmented Gram over
the UNION of structural and instrument columns:

    Ĝ_jk = G_jZ G_ZZ⁻¹ G_Zk        (first stage, one masked solve)
    m̂_j  = G_jZ G_ZZ⁻¹ m_Z

with Z = {intercept} ∪ (exogenous structural columns) ∪ instruments.
Exogenous columns project onto themselves (they sit inside Z), so only the
endogenous block moves; the intercept row and column are restored EXACTLY
from the original Gram (the constant is in Z), which keeps the solve's
centering algebra untouched. The structural solve is then the ordinary
padded solve on the projected stats.

The projected stats get R² wrong: the solve's ``sse = yy − 2β'm + β'Gβ``
would use the first stage's fitted values, while 2SLS residuals are
``y − Xβ`` against the RAW regressors. :func:`iv_r2` recomputes the
quadratic form against the original stats after the solve (2SLS R² can be
negative and is reported as is). ``ysum``, ``yy`` and ``center`` stay raw.

Identification: #instruments ≥ #endogenous at ``Estimator`` construction;
per month, instrument-block rank loss at the eigenvalue cutoff is a
``deficient`` disclosure, and months with fewer rows than max(#Z, #X)
columns are zeroed to fail ``month_valid``.

Plain torch (two ``masked_psd_solve``s and products): the reference's
projections are einsums outside any Pallas kernel. On the card the path's
kernel is the Gram contraction (K2, ``grams.contract_spec_grams``).
"""

from __future__ import annotations

import torch

from fm_returnprediction_tpu_torch.specgrid.estimators.core import masked_psd_solve
from fm_returnprediction_tpu_torch.specgrid.grams import SpecGramStats

__all__ = ["iv_transform", "iv_r2"]


def iv_transform(stats: SpecGramStats, sel_aug: torch.Tensor, z_aug: torch.Tensor,
                 data_eps: float):
    """Project every (spec, month) Gram onto the instrument block.

    ``sel_aug`` (S, Q) bool — structural selection (intercept + exogenous
    + endogenous); ``z_aug`` (S, Q) bool — instrument selection (intercept
    + exogenous + instruments). Returns ``(stats', deficient)``: the
    projected Gram/moment in the structural block, and the (S, T)
    instrument-block rank flag."""
    gram, moment = stats.gram, stats.moment
    dtype = gram.dtype
    zero = torch.zeros((), dtype=dtype, device=gram.device)
    bz = torch.where(z_aug[:, None, :, None], gram, zero)
    m_z = torch.where(z_aug[:, None, :], moment, zero)
    rhs = torch.cat([bz, m_z[..., None]], dim=-1)
    w, deficient = masked_psd_solve(gram, z_aug[:, None, :].expand(gram.shape[:-1]), rhs,
                                    data_eps)
    w_g, w_y = w[..., :-1], w[..., -1]
    g_hat = torch.einsum("stij,stik->stjk", bz, w_g)
    m_hat = torch.einsum("stij,sti->stj", bz, w_y)

    x2 = sel_aug[:, None, :, None] & sel_aug[:, None, None, :]
    g2 = torch.where(x2, g_hat, zero)
    m2 = torch.where(sel_aug[:, None, :], m_hat, zero)
    # the constant is inside Z, so its projection is itself: restore the
    # original intercept row/column (and x'1 = n) exactly
    row0 = torch.where(sel_aug[:, None, :], gram[..., 0, :], zero)
    g2[..., 0, :] = row0
    g2[..., :, 0] = row0
    g2[..., 0, 0] = stats.n
    m2[..., 0] = moment[..., 0]

    q_total = torch.maximum(z_aug.sum(-1), sel_aug.sum(-1))     # (S,)
    ok = stats.n >= q_total[:, None].to(stats.n.dtype)
    okf = ok.to(dtype)
    out = SpecGramStats(
        gram=g2 * okf[..., None, None],
        moment=m2 * okf[..., None],
        n=stats.n * okf,
        # ysum/yy/center stay RAW: intercept recovery and iv_r2 both run
        # against the original y geometry
        ysum=stats.ysum,
        yy=stats.yy,
        center=stats.center,
    )
    return out, deficient & ok


def iv_r2(beta: torch.Tensor, stats: SpecGramStats, month_valid: torch.Tensor) -> torch.Tensor:
    """2SLS R² against the RAW regressors: re-center the solved betas
    (``beta`` (S, T, Q), raw intercept first — ``SpecSolve.beta``) and
    evaluate ``sse = yy − 2β'm + β'Gβ`` on the ORIGINAL stats. Zeros outside
    each spec's selection make masking unnecessary."""
    a_c = beta[..., 0] + torch.einsum("stp,tp->st", beta[..., 1:], stats.center)
    beta_c = torch.cat([a_c[..., None], beta[..., 1:]], dim=-1)
    bg = torch.einsum("...p,...pq,...q->...", beta_c, stats.gram, beta_c)
    bm = torch.einsum("...p,...p->...", beta_c, stats.moment)
    sse = stats.yy - 2.0 * bm + bg
    sst = stats.yy - stats.ysum * stats.ysum / torch.clamp_min(stats.n, 1.0)
    r2 = torch.where(sst > 0, 1.0 - sse / torch.where(sst > 0, sst, torch.ones_like(sst)),
                     torch.zeros_like(sst))
    return torch.where(month_valid, r2, torch.zeros_like(r2))
