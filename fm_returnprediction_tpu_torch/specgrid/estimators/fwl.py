"""Frisch-Waugh-Lovell partialling-out as a Schur complement on per-month
Grams.

The FWL theorem: regressing y on [C | F] gives the same F-coefficients as
(i) residualizing y and every F column on C, then (ii) regressing the y
residuals on the F residuals. Step (i) never needs the panel — residual
cross-products are a SCHUR COMPLEMENT of the month's augmented Gram:

    G'_FF = G_FF − G_FC G_CC⁻¹ G_CF        (residualized Gram)
    m'_F  = m_F  − G_FC G_CC⁻¹ m_C         (residualized x'y)
    yy'   = yy   − m_C' G_CC⁻¹ m_C         (residualized y'y)

with C = {intercept} ∪ controls and F the focal columns, so one (Q, Q)
Gram per month serves every spec sharing the controls, and the focal
slopes of the ordinary padded solve on the transformed stats are the full
regression's.

The transform leaves ordinary ``SpecGramStats``: the intercept row is
reset to ``[n, 0, …]`` (residualized columns are orthogonal to the
constant), ``ysum``/``center`` go to zero (the reported intercept is
exactly 0), and ``yy`` becomes the residual y'y, which makes the solve's R²
the PARTIAL R². Months with fewer rows than the FULL column count
(intercept + controls + focal) are zeroed out, so the solve's
``month_valid = n ≥ q`` gate sees them as empty; control-block rank loss
at the eigenvalue cutoff (``masked_psd_solve``) comes back as a
per-(spec, month) ``deficient`` flag for the suspect disclosure.
"""

from __future__ import annotations

import torch

from fm_returnprediction_tpu_torch.specgrid.estimators.core import masked_psd_solve
from fm_returnprediction_tpu_torch.specgrid.grams import SpecGramStats

__all__ = ["fwl_transform"]


def fwl_transform(stats: SpecGramStats, sel_aug: torch.Tensor, ctrl_aug: torch.Tensor,
                  data_eps: float):
    """Partial the control block out of every (spec, month) Gram.

    ``sel_aug`` (S, Q) bool — the FULL augmented selection (intercept +
    controls + focal columns); ``ctrl_aug`` (S, Q) bool — the block to
    eliminate (intercept + controls, a subset of ``sel_aug``). Returns
    ``(stats', deficient)``: transformed stats whose selected block is the
    focal Schur complement, and the (S, T) control-block rank-deficiency
    flag."""
    gram, moment = stats.gram, stats.moment
    dtype = gram.dtype
    zero = torch.zeros((), dtype=dtype, device=gram.device)
    b = torch.where(ctrl_aug[:, None, :, None], gram, zero)      # rows C of G
    m_c = torch.where(ctrl_aug[:, None, :], moment, zero)
    rhs = torch.cat([b, m_c[..., None]], dim=-1)
    z, deficient = masked_psd_solve(
        gram, ctrl_aug[:, None, :].expand(gram.shape[:-1]), rhs, data_eps)
    z_g, z_y = z[..., :-1], z[..., -1]
    g_proj = gram - torch.einsum("stij,stik->stjk", b, z_g)
    m_proj = moment - torch.einsum("stij,sti->stj", b, z_y)
    yy2 = stats.yy - torch.einsum("sti,sti->st", m_c, z_y)

    fmask = sel_aug & ~ctrl_aug                                   # focal columns
    f2 = fmask[:, None, :, None] & fmask[:, None, None, :]
    g2 = torch.where(f2, g_proj, zero)
    g2[..., 0, 0] = stats.n
    m2 = torch.where(fmask[:, None, :], m_proj, zero)

    # dof gate: a month must carry the FULL design (controls + focal) for
    # the partialled solve to be the full regression's
    q_total = sel_aug.sum(-1)                                     # (S,)
    ok = stats.n >= q_total[:, None].to(stats.n.dtype)
    okf = ok.to(dtype)
    out = SpecGramStats(
        gram=g2 * okf[..., None, None],
        moment=m2 * okf[..., None],
        n=stats.n * okf,
        ysum=torch.zeros_like(stats.ysum),
        yy=torch.clamp_min(yy2, 0.0) * okf,
        center=torch.zeros_like(stats.center),
    )
    return out, deficient & ok
