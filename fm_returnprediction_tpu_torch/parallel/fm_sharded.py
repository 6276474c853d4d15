"""Firm-sharded Fama-MacBeth: the firm axis N of the dense (T, N, P) panel
split over a mesh axis, with explicit collectives between the stages.

The default solve is distributed TSQR. Each shard QR-factors its local
masked ``[X | y]`` block (one batched ``torch.linalg.qr`` over the months),
the small (Q+1) × (Q+1) R factors are gathered along the firm axis in
shard order, and a replicated minimum-norm least squares on the stacked R
``G`` solves the original problem exactly: ``GᵀG = [X|y]ᵀ[X|y]``, so
``‖G_x β − g_y‖ = ‖Xβ − y‖`` for every β and ``cond(G_x) = cond(X)`` —
no squaring of the condition number, unlike a solve of the summed Gram.
When a shard holds no more rows than Q + 1 (the boundary-month regime) its
raw masked rows are stacked instead of an R factor, and the gathered
system is then exactly the global one. ``rcond`` is
``eps · max(global padded rows, Q + 1)``, the single-device QR solve's
cutoff, so both paths truncate the same singular values.

``n_refine=0`` selects the Gram fast path: each shard's per-month
sufficient statistics, one rank-ordered ``psum``, and the pseudo-inverse
solve of ``ops.ols.gram_pinv`` (well-conditioned months only). R² is always
recomputed from the raw residuals of the solved coefficients, one ``psum``
of the per-shard SSE.

The solve after the gather is replicated across the firm axis; it runs once
per group of the axis (not once per shard) and every member gets it.
"""

from __future__ import annotations

from typing import Optional

import torch

from fm_returnprediction_tpu_torch.ops.fama_macbeth import (
    FamaMacbethSummary,
    fama_macbeth_summary,
)
from fm_returnprediction_tpu_torch.ops.ols import (
    CSRegressionResult,
    NormalStats,
    augment_design,
    gram_pinv,
    lstsq_min_norm,
    row_validity,
    sufficient_stats,
)
from fm_returnprediction_tpu_torch.parallel.mesh import (
    Mesh,
    Placed,
    all_gather,
    make_mesh,
    psum,
    shard_panel,
)

__all__ = ["cs_ols_kernel", "monthly_cs_ols_sharded", "fama_macbeth_sharded"]


def _once_per_group(mesh: Mesh, axis: str, fn, *per_position):
    """``fn`` of each local position's arguments, evaluated once per group
    along ``axis`` (the arguments are replicated within a group) and
    handed to every member."""
    group_of = {pos: tuple(g) for g in mesh.axis_groups(axis) for pos in g}
    done = {}
    out = []
    for i, pos in enumerate(mesh.local_positions()):
        key = group_of[pos]
        if key not in done:
            done[key] = fn(*(arg[i] for arg in per_position))
        out.append(done[key])
    return out


def _tsqr_lstsq(mesh: Mesh, x_aug: list, y_z: list, axis: str, n_shards: int) -> list:
    """Distributed minimum-norm least squares by TSQR compression (module
    docstring): per-shard R factors (or raw rows), gathered in shard order,
    solved once per group."""
    n_local, q = x_aug[0].shape[-2], x_aug[0].shape[-1]
    rcond = torch.finfo(x_aug[0].dtype).eps * max(n_shards * n_local, q + 1)
    blocks = []
    for xa, yz in zip(x_aug, y_z):
        m = torch.cat([xa, yz[..., None]], dim=-1)
        # a wide or square block's R is no smaller than the block: stack
        # the raw rows, so the gathered system is exactly the global one
        blocks.append(m if m.shape[-2] <= m.shape[-1] else torch.linalg.qr(m, mode="r").R)
    stacks = all_gather(mesh, blocks, axis)            # (D, T, k, Q+1) each

    def solve(stack):
        d, t, k, q1 = stack.shape
        g = stack.permute(1, 0, 2, 3).reshape(t, d * k, q1)
        return lstsq_min_norm(g[..., :-1], g[..., -1], rcond)

    return _once_per_group(mesh, axis, solve, stacks)


def cs_ols_kernel(mesh: Mesh, y: list, x: list, mask: list, axis_name: str,
                  n_shards: int, n_refine: int) -> list:
    """The per-shard cross-sectional OLS over the shards of one firm axis:
    ``y``, ``x``, ``mask`` are this process's local shards (T', N/D),
    (T', N/D, P), (T', N/D). The only collectives run over ``axis_name``,
    so another mesh axis may split the months (``parallel.multihost``).
    Returns one ``CSRegressionResult`` per local position, the same object
    within a group."""
    valid = [row_validity(yl, xl, ml) for yl, xl, ml in zip(y, x, mask)]
    aug = [augment_design(yl, xl, vl) for yl, xl, vl in zip(y, x, valid)]
    x_aug = [a[0] for a in aug]
    y_z = [a[1] for a in aug]
    v = [a[2] for a in aug]
    q = x_aug[0].shape[-1]
    if n_refine == 0:
        stats = psum(mesh, [sufficient_stats(yl, xl, vl) for yl, xl, vl in zip(y, x, valid)],
                     axis_name)

        def gram_solve(s):
            s = NormalStats(*s)
            pinv, month_valid = gram_pinv(s)
            beta = (pinv @ s.moment[..., None])[..., 0]
            return beta, month_valid, s.n, s.ysum, s.yy

        solved = _once_per_group(mesh, axis_name, gram_solve, stats)
        beta = [s[0] for s in solved]
        month_valid = [s[1] for s in solved]
        sums = [s[2:] for s in solved]
    else:
        sums = psum(mesh, [(vl.sum(-1), yl.sum(-1), (yl * yl).sum(-1))
                           for vl, yl in zip(v, y_z)], axis_name)
        month_valid = [s[0] >= q for s in sums]
        beta = _tsqr_lstsq(mesh, x_aug, y_z, axis_name, n_shards)
    beta = [torch.where(mv[:, None], b, torch.zeros_like(b)) for b, mv in zip(beta, month_valid)]

    # R² from the raw residuals of the solved coefficients (centered, as
    # statsmodels' rsquared), not from the rounded Gram
    sse_parts = []
    for xa, yz, vl, b in zip(x_aug, y_z, v, beta):
        resid = (yz - (xa @ b[:, :, None])[..., 0]) * vl
        sse_parts.append((resid * resid).sum(dim=1))
    sse = psum(mesh, sse_parts, axis_name)

    def finish(b, mv, s, e):
        n, ysum, yy = s
        sst = yy - ysum * ysum / torch.clamp_min(n, 1.0)
        r2 = torch.where(sst > 0, 1.0 - e / torch.where(sst > 0, sst, torch.ones_like(sst)),
                         torch.zeros_like(sst))
        r2 = torch.where(mv, r2, torch.zeros_like(r2))
        return CSRegressionResult(b[:, 1:], b[:, 0], r2, n, mv)

    return _once_per_group(mesh, axis_name, finish, beta, month_valid, sums, sse)


def monthly_cs_ols_sharded(y: Placed, x: Placed, mask: Placed, mesh: Mesh,
                           axis_name: str = "firms", n_refine: int = 2) -> CSRegressionResult:
    """Every month's cross-sectional OLS with the firm axis sharded over
    ``mesh`` (inputs placed by ``mesh.shard_panel``). ``n_refine >= 1`` (the
    default) is distributed TSQR, ``0`` the Gram fast path (the name is the
    reference's). Returns the replicated result, on the mesh's first
    device."""
    out = cs_ols_kernel(mesh, y.shards, x.shards, mask.shards, axis_name,
                        mesh.shape[axis_name], n_refine)
    return out[0]


def fama_macbeth_sharded(
    y,
    x,
    mask,
    mesh: Optional[Mesh] = None,
    nw_lags: int = 4,
    min_months: int = 10,
    weight: str = "reference",
    axis_name: str = "firms",
    place: bool = True,
    n_refine: int = 2,
) -> tuple[CSRegressionResult, FamaMacbethSummary]:
    """End-to-end FM with the firm axis sharded: place the panel (pad the
    firms, ``place=True``), solve every month, aggregate. ``mesh=None`` is
    every local device of ``y``'s kind. Returns ``(cs, summary)`` on the
    mesh's first device."""
    if mesh is None:
        kind = y.device.type if isinstance(y, torch.Tensor) else None
        mesh = make_mesh(axis_name=axis_name, device=kind)
    if place:
        y, x, mask = shard_panel(y, x, mask, mesh, axis_name=axis_name)
    cs = monthly_cs_ols_sharded(y, x, mask, mesh, axis_name=axis_name,
                                n_refine=min(n_refine, 1))
    return cs, fama_macbeth_summary(cs, nw_lags=nw_lags, min_months=min_months,
                                    weight=weight)
