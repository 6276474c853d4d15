"""Batched Gram solve + FM aggregation for a spec grid, with a QR referee.

The ``(S, T, Q, Q)`` Gram stats (``specgrid.grams``) become per-month
slopes/R² and Fama-MacBeth summaries for EVERY spec: pad each spec's
unselected Gram rows/columns to identity, Jacobi-equilibrate (symmetric
diagonal scaling, leaving the correlation-matrix condition number),
eigendecompose the small symmetric systems and solve with a pinv-style
eigenvalue cutoff.

Numerics contract. The Gram route squares the design's condition number,
so months the Gram algebra cannot defend are flagged SUSPECT and any spec
containing one is re-solved wholesale by the REFEREE — the per-cell batched
QR route (``ops.fama_macbeth``). The gate is decided at the precision the
stats were contracted in:

- STRUCTURAL (always): rank-deficient at the data-eps pinv cutoff, or
  exactly determined (n == Q);
- CONDITIONING (float64 panels only): equilibrated condition beyond
  ``1/√eps``. For float32 panels this tier is off: the float32 QR route is
  farther from float64 truth than the centered equilibrated Gram solve.

The solve runs in the stats' own dtype.

With the guard layer on (``guard.checks``) ``run_spec_grid`` queues the
grid's sentinel counters under ``"specgrid.grid_program"`` — non-finite
Gram/moment entries, and months conditioned beyond ``1/√eps`` that no
referee re-solves (only possible on float32 panels, where the conditioning
tier is off) — and each referee solve records as ``"ols.fama_macbeth"``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.guard import checks as _guard
from fm_returnprediction_tpu_torch.ops.fama_macbeth import (
    FamaMacbethSummary,
    fama_macbeth,
    fama_macbeth_summary,
)
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult
from fm_returnprediction_tpu_torch.specgrid.grams import contract_spec_grams
from fm_returnprediction_tpu_torch.specgrid.specs import SpecGrid

__all__ = ["SpecSolve", "SpecGridResult", "solve_spec_stats", "run_spec_grid"]


class SpecSolve(NamedTuple):
    """Per-month Gram-solve leaves, spec-major."""

    beta: torch.Tensor         # (S, T, Q) intercept first; 0 on unselected
    r2: torch.Tensor           # (S, T)
    month_valid: torch.Tensor  # (S, T) bool: n >= q_s
    suspect: torch.Tensor      # (S, T) bool: Gram solve not trustworthy


class SpecGridResult(NamedTuple):
    """Host-side result of a grid run (numpy leaves, spec axis leading).
    ``slopes``/``coef``/``tstat``/``nw_se`` are laid out over the UNION
    predictor columns with NaN in each spec's unselected columns;
    ``referee_specs`` lists the specs the QR referee re-solved."""

    slopes: np.ndarray          # (S, T, P)
    intercept: np.ndarray       # (S, T)
    r2: np.ndarray              # (S, T)
    n_obs: np.ndarray           # (S, T)
    month_valid: np.ndarray     # (S, T)
    coef: np.ndarray            # (S, P)
    tstat: np.ndarray           # (S, P)
    nw_se: np.ndarray           # (S, P)
    mean_r2: np.ndarray         # (S,)
    mean_n: np.ndarray          # (S,)
    n_months: np.ndarray        # (S,)
    suspect_months: np.ndarray  # (S,) count flagged by the Gram solve
    referee_specs: Tuple[int, ...]

    def spec_summary(self, grid: SpecGrid, s: int) -> FamaMacbethSummary:
        """One spec's FM summary restricted to its own predictor order."""
        pos = grid.column_positions(grid.specs[s])
        return FamaMacbethSummary(
            coef=self.coef[s, pos], tstat=self.tstat[s, pos],
            nw_se=self.nw_se[s, pos], mean_r2=self.mean_r2[s],
            mean_n=self.mean_n[s], n_months=self.n_months[s],
        )

    def spec_cs(self, grid: SpecGrid, s: int) -> CSRegressionResult:
        """One spec's per-month cross-sections in its own predictor order
        (numpy leaves)."""
        pos = grid.column_positions(grid.specs[s])
        return CSRegressionResult(
            slopes=self.slopes[s][:, pos], intercept=self.intercept[s],
            r2=self.r2[s], n_obs=self.n_obs[s],
            month_valid=self.month_valid[s],
        )


def solve_spec_stats(stats, sel_aug: torch.Tensor, guard: bool = False):
    """Solve every (spec, month) padded Gram system.

    ``sel_aug`` (S, Q) bool selects augmented columns (intercept always
    True). Unselected rows/columns are replaced by identity, so the padded
    eigendecomposition solves exactly the selected subsystem with zeros
    elsewhere. Returns ``(SpecSolve, counters)``: with ``guard`` the
    sentinel counters, computed from the eigenvalues the solve already
    holds; without it None, and no extra tensor is computed.
    """
    gram, moment, n, ysum, yy, center = stats
    dtype = gram.dtype
    q = gram.shape[-1]
    eps = torch.finfo(dtype).eps
    cond_limit = 1.0 / np.sqrt(eps)
    cond_tier = dtype == torch.float64

    q_s = sel_aug.sum(-1).to(dtype)                               # (S,)
    month_valid = n >= q_s[:, None]                               # (S, T)

    sel2 = sel_aug[:, None, :, None] & sel_aug[:, None, None, :]
    eye = torch.eye(q, dtype=dtype, device=gram.device)
    g = torch.where(sel2, gram, eye)
    g = torch.where(month_valid[..., None, None], g, eye)
    m = torch.where(sel_aug[:, None, :], moment, torch.zeros_like(moment))
    m = torch.where(month_valid[..., None], m, torch.zeros_like(m))

    # Jacobi equilibration: the selected block's diagonal becomes 1
    dg = torch.diagonal(g, dim1=-2, dim2=-1)                      # (S, T, Q)
    scale = torch.where(dg > 0, torch.rsqrt(torch.clamp_min(dg, eps)),
                        torch.ones_like(dg))
    gs = g * scale[..., :, None] * scale[..., None, :]
    # a system with a non-finite entry (an overflowed Gram) gets NaN
    # eigenpairs, so its months come out suspect and the referee re-solves
    # the spec; torch's eigh raises on such input, so it decomposes the
    # identity in its place
    broken = ~torch.isfinite(gs).all(dim=-1).all(dim=-1)          # (S, T)
    w, v = torch.linalg.eigh(torch.where(broken[..., None, None], eye, gs))
    w = torch.where(broken[..., None], float("nan"), w)           # ascending
    v = torch.where(broken[..., None, None], float("nan"), v)
    wmax = w[..., -1]
    cutoff = q * eps * wmax
    winv = torch.where(w > cutoff[..., None], 1.0 / torch.clamp_min(w, eps),
                       torch.zeros_like(w))
    ms = m * scale
    t1 = torch.einsum("...qk,...q->...k", v, ms)
    beta = scale * torch.einsum("...qk,...k->...q", v, t1 * winv)
    keep = sel_aug[:, None, :] & month_valid[..., None]
    beta = torch.where(keep, beta, torch.zeros_like(beta))

    # rank over the SELECTED block: padded identity rows contribute
    # eigenvalues of exactly 1, always above the cutoff
    rank_sel = (w > cutoff[..., None]).sum(-1) - (q - q_s[:, None])
    rank_deficient = rank_sel < q_s[:, None]
    suspect = rank_deficient | (n <= q_s[:, None])
    if cond_tier:
        suspect = suspect | (w[..., 0] * cond_limit < wmax)
    suspect = month_valid & suspect

    # R² in the shifted basis (residuals are identical to the raw basis)
    bg = torch.einsum("...p,...pq,...q->...", beta, g, beta)
    bm = torch.einsum("...p,...p->...", beta, m)
    sse = yy - 2.0 * bm + bg
    sst = yy - ysum * ysum / torch.clamp_min(n, 1.0)
    r2 = torch.where(sst > 0, 1.0 - sse / torch.where(sst > 0, sst, torch.ones_like(sst)),
                     torch.zeros_like(sst))
    r2 = torch.where(month_valid, r2, torch.zeros_like(r2))

    # undo the column shift: raw intercept a = a_c − Σ b_p c_p
    intercept = beta[..., 0] - torch.einsum("stp,tp->st", beta[..., 1:], center)
    beta = torch.cat([intercept[..., None], beta[..., 1:]], dim=-1)
    sol = SpecSolve(beta, r2, month_valid, suspect)
    if not guard:
        return sol, None
    # suspect months are a handled condition (the referee re-solves them),
    # so only conditioning beyond 1/√eps on months no referee touches counts
    ill = w[..., 0] * cond_limit < wmax
    return sol, {
        "gram_nonfinite_entries": _guard.nonfinite_count(gram) + _guard.nonfinite_count(m),
        "cond_exceeded_months": (month_valid & ill & ~suspect).sum(),
    }


def _solve_and_aggregate(stats, col_sel: torch.Tensor, out_dtype, *,
                         nw_lags: int, min_months: int, weight: str, guard: bool):
    """Padded Gram solve + FM aggregation over the spec axis; the sentinel
    counters (None without ``guard``) come last."""
    s_specs = col_sel.shape[0]
    sel_aug = torch.cat(
        [torch.ones((s_specs, 1), dtype=torch.bool, device=col_sel.device),
         col_sel], dim=1,
    )
    sol, counters = solve_spec_stats(stats, sel_aug, guard=guard)
    slopes = torch.where(col_sel[:, None, :], sol.beta[..., 1:],
                         torch.full_like(sol.beta[..., 1:], float("nan")))
    cs = CSRegressionResult(
        slopes=slopes.to(out_dtype),
        intercept=sol.beta[..., 0].to(out_dtype),
        r2=sol.r2.to(out_dtype),
        n_obs=stats.n.to(out_dtype),
        month_valid=sol.month_valid,
    )
    fm = fama_macbeth_summary(cs, nw_lags=nw_lags, min_months=min_months,
                              weight=weight)
    return cs, fm, sol.suspect, counters


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy().copy()


def run_spec_grid(y: torch.Tensor, x: torch.Tensor,
                  universe_masks: Dict[str, torch.Tensor], grid: SpecGrid,
                  firm_chunk=None) -> SpecGridResult:
    """Solve a whole spec grid from panel tensors.

    ``x`` holds the grid's union predictor columns in
    ``grid.union_predictors`` order; ``universe_masks`` maps universe name →
    (T, N) bool, all on the device of ``y``. Any spec containing a suspect
    month is re-solved by the per-cell batched QR route (the referee), so
    its numbers are exactly that route's. ``firm_chunk`` sets the plain
    contraction's firm slice width.
    """
    device = y.device
    names = list(universe_masks)
    universes = torch.stack([torch.as_tensor(universe_masks[nm], device=device)
                             for nm in names])
    t = y.shape[0]
    uidx = torch.as_tensor(grid.universe_index(names), device=device)
    col_sel = torch.as_tensor(grid.column_selector(), device=device)
    window = torch.as_tensor(grid.window_masks(t), device=device)

    stats = contract_spec_grams(y, x, universes, uidx, col_sel, window,
                                firm_chunk=firm_chunk)
    guard = _guard.guard_active()
    cs, fm, suspect, counters = _solve_and_aggregate(
        stats, col_sel, y.dtype, nw_lags=grid.nw_lags,
        min_months=grid.min_months, weight=grid.weight, guard=guard,
    )
    if guard:
        _guard.record("specgrid.grid_program", counters)
    suspect_months = _host(suspect).sum(axis=1).astype(np.int64)
    flagged = [int(s) for s in np.nonzero(suspect_months > 0)[0]]

    slopes, intercept, r2 = _host(cs.slopes), _host(cs.intercept), _host(cs.r2)
    n_obs, month_valid = _host(cs.n_obs), _host(cs.month_valid)
    coef, tstat, nw_se = _host(fm.coef), _host(fm.tstat), _host(fm.nw_se)
    mean_r2, mean_n = _host(fm.mean_r2), _host(fm.mean_n)
    n_months = _host(fm.n_months)
    for s in flagged:
        spec = grid.specs[s]
        pos = grid.column_positions(spec)
        mask = universes[uidx[s]] & window[s][:, None]
        ref_cs, ref_fm = fama_macbeth(
            y, x[:, :, pos], mask, nw_lags=grid.nw_lags,
            min_months=grid.min_months, weight=grid.weight,
        )
        slopes[s] = np.nan
        slopes[s][:, pos] = _host(ref_cs.slopes)
        intercept[s] = _host(ref_cs.intercept)
        r2[s] = _host(ref_cs.r2)
        n_obs[s] = _host(ref_cs.n_obs)
        month_valid[s] = _host(ref_cs.month_valid)
        coef[s] = np.nan
        coef[s][pos] = _host(ref_fm.coef)
        tstat[s] = np.nan
        tstat[s][pos] = _host(ref_fm.tstat)
        nw_se[s] = np.nan
        nw_se[s][pos] = _host(ref_fm.nw_se)
        mean_r2[s] = _host(ref_fm.mean_r2)
        mean_n[s] = _host(ref_fm.mean_n)
        n_months[s] = _host(ref_fm.n_months)
    return SpecGridResult(
        slopes, intercept, r2, n_obs, month_valid, coef, tstat, nw_se,
        mean_r2, mean_n, n_months, suspect_months, tuple(flagged),
    )
