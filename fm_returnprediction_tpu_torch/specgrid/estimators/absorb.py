"""Absorbed fixed effects: alternating projections on per-month CELL
sufficient statistics.

The within transform never needs row-level residuals. For FE factors with
codes ``(a, b)`` per row, everything the demeaned Gram needs is the FE
crossing's cell statistics per (spec, month):

    n_cell[a, b]  = Σ_{i∈cell} w_i                     counts
    s_cell[a, b]  = Σ_{i∈cell} w_i v_i                 sums of v = [x̃, y]

(:func:`contract_absorb_cells`, the one panel pass the estimator makes, and
the reason absorb is the one kind the Gram bank cannot serve). Alternating
projections then run on AGGREGATES, the zig-zag (Halperin) iteration

    α_a ← (s_a − Σ_b n_cell[a,b] β_b) / n_a
    β_b ← (s_b − Σ_a n_cell[a,b] α_a) / n_b

whose fixed point is the demeaning; one-way FE is a single exact
projection. Whatever FE values the iteration holds, the demeaned-Gram
identity

    G_w = G_raw − A'S − S'A + Σ_cell n_cell a_cell a_cell'

(``a_cell = α_a + β_b``) is EXACT for those values, so a non-converged
two-way demeaning is an honestly disclosed approximate demeaning (the
``absorb_iters``/``absorb_converged`` disclosures), never a silently wrong
Gram. The transformed stats drop the intercept (the constant lies in the
span of the FE dummies), zero ``ysum``/``center``, and gate the dof: a
month must carry ``#columns + #levels-present − 1`` rows.

Plain torch, as the reference's ``segment_sum``/einsum are outside any
Pallas kernel. The cell sums are ORDERED: the (T·N) segment keys
``t·ga·gb + a·gb + b`` are sorted once (stably; the codes do not depend on
the spec), and each spec's weighted rows are summed over the sorted runs by
``ops.daily_kernels.segment_sum`` (rows added in order), so the cells are
the same bits on every run, where ``index_add_``'s atomics would not be.
The zig-zag stops once every (spec, month) has converged, which gives the
reference's values: its fixed-count loop leaves converged cells frozen.
"""

from __future__ import annotations

import torch

from fm_returnprediction_tpu_torch.ops.daily_kernels import segment_sum
from fm_returnprediction_tpu_torch.specgrid.grams import SpecGramStats

__all__ = ["contract_absorb_cells", "absorb_transform"]


def contract_absorb_cells(y, x, universes, uidx, col_sel, window, center, codes_a, codes_b,
                          row_weights=None, *, ga: int, gb: int):
    """One panel pass → per-(spec, month) FE cell statistics.

    ``y`` (T, N), ``x`` (T, N, P), ``universes`` (U, T, N) bool, ``uidx``
    (S,), ``col_sel`` (S, P) bool, ``window`` (S, T) bool, ``center``
    (T, P), ``codes_a``/``codes_b`` (T, N) int in [0, ga)/[0, gb) (one-way:
    ``gb=1`` and zeros). Row validity is the contraction's own rule —
    universe ∧ finite(y) ∧ finite(selected x) ∧ window — so cell counts sum
    to ``SpecGramStats.n``; ``row_weights`` (T, N) is the coreset route's
    importance weighting, applied as ``contract_spec_grams`` applies it.
    Returns ``(n_cells (S, T, ga, gb), s_cells (S, T, ga, gb, V))`` with
    V = P + 1 over ``v = [x − center, y]`` (unselected columns zeroed)."""
    t, n, p = x.shape
    dev = x.device
    g = ga * gb
    seg = (torch.arange(t, device=dev)[:, None] * g
           + codes_a.to(dev, torch.int64) * gb + codes_b.to(dev, torch.int64)).reshape(-1)
    # one stable sort of the segment keys serves every spec
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=t * g)
    x_fin = torch.isfinite(x)
    y_fin = torch.isfinite(y)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    x_c = torch.where(x_fin, x - center[:, None, :], zero)
    y_z = torch.where(y_fin, y, zero)
    n_out, s_out = [], []
    for s in range(col_sel.shape[0]):
        sel = col_sel[s]
        valid = (y_fin & window[s][:, None] & universes[uidx[s]]
                 & torch.all(x_fin | ~sel, dim=-1))
        w = valid.to(x.dtype)                                # (T, N)
        if row_weights is not None:
            w = w * row_weights
        rows = torch.cat([w[..., None], torch.where(sel, x_c, zero) * w[..., None],
                          (y_z * w)[..., None]], dim=-1).reshape(t * n, p + 2)
        cells = segment_sum(rows[order], lengths).reshape(t, ga, gb, p + 2)
        n_out.append(cells[..., 0])
        s_out.append(cells[..., 1:])
        del rows, cells
    return torch.stack(n_out), torch.stack(s_out)


def absorb_transform(stats: SpecGramStats, sel_aug: torch.Tensor, n_cells: torch.Tensor,
                     s_cells: torch.Tensor, *, n_fe: int, tol: float, max_iter: int):
    """Demean every (spec, month) Gram against the FE crossing.

    Returns ``(stats', iters, delta)``: the within-transformed stats, the
    (S, T) alternating-projection sweep counts used, and the (S, T) final
    sup-norm change (``delta ≤ tol`` ⇔ converged; one-way FE is exact in
    one sweep)."""
    dtype = stats.gram.dtype
    dev = stats.gram.device
    n_cells = n_cells.to(dtype)
    s_cells = s_cells.to(dtype)
    n1 = n_cells.sum(-1)                                     # (S, T, ga)
    n2 = n_cells.sum(-2)                                     # (S, T, gb)
    s1 = s_cells.sum(-2)                                     # (S, T, ga, V)
    s2 = s_cells.sum(-3)                                     # (S, T, gb, V)
    d1 = torch.clamp_min(n1, 1.0)[..., None]
    d2 = torch.clamp_min(n2, 1.0)[..., None]

    a1 = s1 / d1
    a2 = torch.zeros_like(s2)
    s_mt = stats.n.shape                                     # (S, T)
    if n_fe == 1:
        iters = torch.ones(s_mt, dtype=torch.int32, device=dev)
        delta = torch.zeros(s_mt, dtype=dtype, device=dev)
    else:
        delta = torch.full(s_mt, float("inf"), dtype=dtype, device=dev)
        iters = torch.zeros(s_mt, dtype=torch.int32, device=dev)
        n_t = n_cells.transpose(-1, -2)                      # (S, T, gb, ga)
        for _ in range(int(max_iter)):
            live = delta > tol
            if not bool(live.any()):
                break                                        # every cell frozen
            a1n = (s1 - n_cells @ a2) / d1
            a2n = (s2 - n_t @ a1n) / d2
            step = torch.maximum((a1n - a1).abs().amax(dim=(-2, -1)),
                                 (a2n - a2).abs().amax(dim=(-2, -1)))
            keep = live[..., None, None]
            a1 = torch.where(keep, a1n, a1)
            a2 = torch.where(keep, a2n, a2)
            delta = torch.where(live, step, delta)
            iters = iters + live.to(torch.int32)

    a_cell = a1[..., :, None, :] + a2[..., None, :, :]       # (S, T, ga, gb, V)
    sh = a_cell.shape
    a_flat = a_cell.reshape(*sh[:2], -1, sh[-1])             # (S, T, G, V)
    as_ = a_flat.transpose(-1, -2) @ s_cells.reshape(a_flat.shape)
    naa = (a_flat * n_cells.reshape(*sh[:2], -1, 1)).transpose(-1, -2) @ a_flat

    p = stats.center.shape[-1]
    g_raw = torch.cat([
        torch.cat([stats.gram[..., 1:, 1:], stats.moment[..., 1:, None]], dim=-1),
        torch.cat([stats.moment[..., None, 1:], stats.yy[..., None, None]], dim=-1),
    ], dim=-2)                                               # (S, T, V, V)
    g_w = g_raw - as_ - as_.transpose(-1, -2) + naa

    zero = torch.zeros((), dtype=dtype, device=dev)
    col_sel = sel_aug[:, 1:]
    sel2 = col_sel[:, None, :, None] & col_sel[:, None, None, :]
    gram2 = torch.zeros_like(stats.gram)
    gram2[..., 1:, 1:] = torch.where(sel2, g_w[..., :p, :p], zero)
    gram2[..., 0, 0] = stats.n
    moment2 = torch.zeros_like(stats.moment)
    moment2[..., 1:] = torch.where(col_sel[:, None, :], g_w[..., :p, p], zero)
    yy2 = torch.clamp_min(g_w[..., p, p], 0.0)

    # dof gate: absorbing k FE levels spends k − 1 dof beyond the constant
    # the solve already charges for
    levels = (n1 > 0).sum(-1)
    if n_fe == 2:
        levels = levels + (n2 > 0).sum(-1) - 1
    q_total = sel_aug.sum(-1)[:, None] + torch.clamp_min(levels - 1, 0)
    ok = stats.n >= q_total.to(stats.n.dtype)
    okf = ok.to(dtype)
    out = SpecGramStats(
        gram=gram2 * okf[..., None, None],
        moment=moment2 * okf[..., None],
        n=stats.n * okf,
        ysum=torch.zeros_like(stats.ysum),
        yy=yy2 * okf,
        center=torch.zeros_like(stats.center),
    )
    return out, iters, torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
