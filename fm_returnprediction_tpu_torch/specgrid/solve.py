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
- CONDITIONING (float64 panels, and stats contracted in bfloat16):
  equilibrated condition beyond ``1/√eps`` of the precision the stats were
  contracted in. For float32 panels this tier is off: the float32 QR route
  is farther from float64 truth than the centered equilibrated Gram solve.
  For bfloat16-contracted stats it is on at ``1/√eps(bf16)``, so a month
  the bfloat16 Gram cannot defend sends its spec back to the
  full-precision QR route (the promotion ``suspect_months`` discloses).

The solve runs in the stats' own dtype (float32 for bfloat16 stats).

``run_spec_grid_weights`` solves a grid once for several Newey-West weight
schemes, optionally on the factorized route (one contraction per distinct
(universe, col_sel) pair, windows applied to the additive per-month stats
by ``expand_window_stats``), with coreset row weights (the referee is then
off: it would re-solve on the full panel) or bfloat16 operands. With
``procs`` > 1 (``FMRP_SPECGRID_PROCS``) the contraction runs across that
many worker processes (``specgrid.multiproc``) and the solve here; with a
``mesh`` the contraction shards over firms and the solve over specs
(``specgrid.sharded``). ``run_spec_grid_on_panel`` slices the grid's
tensors from a ``DensePanel`` first.

With the guard layer on (``guard.checks``) a grid run queues its sentinel
counters under ``"specgrid.grid_program"`` — non-finite Gram/moment
entries, and months conditioned beyond ``1/√eps`` that no referee
re-solves (only possible on float32 panels, where the conditioning tier is
off) — and each referee solve records as ``"ols.fama_macbeth"``.
"""

from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.guard import checks as _guard
from fm_returnprediction_tpu_torch.ops.fama_macbeth import (
    FamaMacbethSummary,
    fama_macbeth,
    fama_macbeth_summary,
)
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult
from fm_returnprediction_tpu_torch.specgrid.grams import (
    SpecGramStats,
    contract_spec_grams,
    resolve_gram_factorize,
    resolve_gram_precision,
    unique_pairs,
)
from fm_returnprediction_tpu_torch.specgrid.multiproc import (
    multiproc_grid_stats,
    resolve_specgrid_procs,
)
from fm_returnprediction_tpu_torch.specgrid.specs import SpecGrid

__all__ = [
    "SpecSolve",
    "SpecGridResult",
    "contraction_counts",
    "expand_window_stats",
    "resolve_specgrid_procs",
    "solve_spec_stats",
    "run_spec_grid",
    "run_spec_grid_weights",
    "run_spec_grid_on_panel",
]

# contraction work, per grid call: specs solved, and spec rows (legacy) or
# pair rows (factorized) contracted; the tile engine reports the deltas
CONTRACTIONS: collections.Counter = collections.Counter()

# bfloat16's machine epsilon, the precision bf16-contracted stats carry
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)


def contraction_counts() -> Dict[str, int]:
    """Snapshot of the contraction-work counters."""
    return dict(CONTRACTIONS)


def expand_window_stats(stats, pair_idx: torch.Tensor, window: torch.Tensor):
    """Per-spec windowed stats from per-pair unwindowed stats, the solve
    side of the factorized route (``grams.unique_pairs``). Exact: every
    per-month leaf is a sum over that month's rows and a window multiplies
    every row weight of a month by the same 0/1. ``pair_idx`` (S,) gathers
    each spec's pair row; ``window`` (S, T) bool is its month mask."""
    gram, moment, n, ysum, yy, center = stats
    w = window.to(gram.dtype)
    return SpecGramStats(
        gram[pair_idx] * w[:, :, None, None],
        moment[pair_idx] * w[:, :, None],
        n[pair_idx] * w,
        ysum[pair_idx] * w,
        yy[pair_idx] * w,
        center,
    )


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


# the most (Q, Q) systems one batched eigh call takes: on an H100 with CUDA
# 12.8, cuSOLVER's batched solver refuses 32,767 systems of 15 × 15 (float32
# and float64) and takes 24,576; the 117-spec sweep has 70,200
EIGH_BATCH = 16384


def _eigh(a: torch.Tensor):
    """``torch.linalg.eigh`` over the leading axes, in slices of at most
    ``EIGH_BATCH`` systems (one call below that, so those bits are the
    unsliced call's)."""
    flat = a.reshape(-1, *a.shape[-2:])
    if flat.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(a)
    parts = [torch.linalg.eigh(flat[i:i + EIGH_BATCH])
             for i in range(0, flat.shape[0], EIGH_BATCH)]
    w = torch.cat([pt[0] for pt in parts]).reshape(a.shape[:-1])
    v = torch.cat([pt[1] for pt in parts]).reshape(a.shape)
    return w, v


def solve_spec_stats(stats, sel_aug: torch.Tensor, guard: bool = False,
                     contracted_eps: Optional[float] = None):
    """Solve every (spec, month) padded Gram system.

    ``sel_aug`` (S, Q) bool selects augmented columns (intercept always
    True). Unselected rows/columns are replaced by identity, so the padded
    eigendecomposition solves exactly the selected subsystem with zeros
    elsewhere. ``contracted_eps`` declares that the stats were contracted
    below their storage precision (bfloat16 stats stored in float32): the
    pinv cutoff then uses that eps and the conditioning tier turns on at
    ``1/√contracted_eps``. Returns ``(SpecSolve, counters)``: with
    ``guard`` the sentinel counters, computed from the eigenvalues the
    solve already holds; without it None, and no extra tensor is computed.
    """
    gram, moment, n, ysum, yy, center = stats
    dtype = gram.dtype
    q = gram.shape[-1]
    eps = torch.finfo(dtype).eps if contracted_eps is None else float(contracted_eps)
    cond_limit = 1.0 / np.sqrt(eps)
    cond_tier = dtype == torch.float64 or contracted_eps is not None

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
    w, v = _eigh(torch.where(broken[..., None, None], eye, gs))
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
                         nw_lags: int, min_months: int, weights: Tuple[str, ...],
                         guard: bool, precision: str = "highest"):
    """Padded Gram solve + FM aggregation over the spec axis, once per NW
    weight scheme: ``(cs, fms, suspect, counters)``, the sentinel counters
    None without ``guard``."""
    s_specs = col_sel.shape[0]
    sel_aug = torch.cat(
        [torch.ones((s_specs, 1), dtype=torch.bool, device=col_sel.device),
         col_sel], dim=1,
    )
    sol, counters = solve_spec_stats(
        stats, sel_aug, guard=guard,
        contracted_eps=BF16_EPS if precision == "bf16" else None)
    slopes = torch.where(col_sel[:, None, :], sol.beta[..., 1:],
                         torch.full_like(sol.beta[..., 1:], float("nan")))
    cs = CSRegressionResult(
        slopes=slopes.to(out_dtype),
        intercept=sol.beta[..., 0].to(out_dtype),
        r2=sol.r2.to(out_dtype),
        n_obs=stats.n.to(out_dtype),
        month_valid=sol.month_valid,
    )
    fms = tuple(fama_macbeth_summary(cs, nw_lags=nw_lags, min_months=min_months,
                                     weight=w) for w in weights)
    return cs, fms, sol.suspect, counters


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy().copy()


def run_spec_grid(y: torch.Tensor, x: torch.Tensor,
                  universe_masks: Dict[str, torch.Tensor], grid: SpecGrid,
                  referee: bool = True, firm_chunk=None, mesh=None,
                  procs: Optional[int] = None, row_weights=None,
                  precision: Optional[str] = None,
                  factorize: Optional[str] = None) -> SpecGridResult:
    """Solve a whole spec grid from panel tensors.

    ``x`` holds the grid's union predictor columns in
    ``grid.union_predictors`` order; ``universe_masks`` maps universe name →
    (T, N) bool, all on the device of ``y``. With ``referee`` any spec
    containing a suspect month is re-solved by the per-cell batched QR
    route, so its numbers are exactly that route's. ``firm_chunk`` sets the
    plain contraction's firm slice width; the other options are
    ``run_spec_grid_weights``'."""
    return run_spec_grid_weights(
        y, x, universe_masks, grid, (grid.weight,), referee=referee,
        firm_chunk=firm_chunk, row_weights=row_weights, precision=precision,
        factorize=factorize, procs=procs, mesh=mesh,
    )[grid.weight]


def run_spec_grid_weights(
    y: torch.Tensor,
    x: torch.Tensor,
    universe_masks: Dict[str, torch.Tensor],
    grid: SpecGrid,
    weights: Tuple[str, ...],
    referee: bool = True,
    firm_chunk=None,
    mesh=None,
    procs: Optional[int] = None,
    row_weights=None,
    precision: Optional[str] = None,
    factorize: Optional[str] = None,
    pair_pad: Optional[int] = None,
) -> Dict[str, SpecGridResult]:
    """``run_spec_grid`` for several NW weight schemes at once: the panel
    contraction and Gram solve run once, and each scheme re-aggregates the
    per-month series (``grid.weight`` is ignored in favour of ``weights``).

    ``precision`` (``FMRP_GRAM_PRECISION`` when None) ``"bf16"`` contracts
    bfloat16 operands; the conditioning referee is then on at bf16's eps
    and promotes the specs it flags to the full-precision QR route, with
    ``suspect_months`` disclosing the count. ``factorize``
    (``FMRP_GRAM_FACTORIZE`` when None): ``"on"`` contracts once per
    unique (universe, col_sel) pair and applies each spec's window to the
    additive per-month stats (``expand_window_stats``, exact); ``"auto"``
    does so only where the grid repeats pairs; ``"off"`` contracts per
    spec. ``pair_pad`` pads the pair axis with inert repeats of pair 0.
    ``row_weights`` (T, N) is the coreset route's importance weighting; the
    referee is off with it (it would re-solve on the full panel and splice
    two estimands). ``procs`` (``FMRP_SPECGRID_PROCS`` when None) > 1
    contracts across that many worker processes on ``y``'s device type
    (``specgrid.multiproc``): not with bf16 operands, nor with
    ``factorize="on"`` (``"auto"`` is off there). ``mesh`` (a 1-D mesh,
    ``specgrid.sharded``) contracts firm-sharded and solves spec-sharded;
    it excludes ``procs`` > 1, bf16 and ``factorize="on"`` alike."""
    precision = resolve_gram_precision(precision)
    factorize = resolve_gram_factorize(factorize)
    procs = resolve_specgrid_procs(procs)
    if mesh is not None and procs > 1:
        raise ValueError(
            "mesh= and procs>1 are mutually exclusive sharding stories: the mesh "
            "spans devices in one process, FMRP_SPECGRID_PROCS spans processes — "
            "pick one per run")
    if mesh is not None and precision == "bf16":
        raise ValueError(
            "precision='bf16' is a single-device route; the mesh path's psum merge of "
            "bf16-floored stats is not refereed yet")
    if procs > 1 and precision == "bf16":
        raise ValueError(
            "precision='bf16' is a single-process route; the host-side merge of "
            "bf16-floored shard stats is not refereed yet")
    if factorize == "on" and (mesh is not None or procs > 1):
        raise ValueError(
            "factorize='on' is a single-device route: the mesh and multi-process "
            "contractions predate the month-axis factorization (their window term "
            "stays in validity); 'auto' resolves to the legacy route there")
    # the worker pool is keyed on the caller's own objects, captured
    # before any conversion below
    raw_rw = row_weights
    device = y.device
    names = list(universe_masks)
    universes = torch.stack([torch.as_tensor(universe_masks[nm], device=device)
                             for nm in names])
    t = y.shape[0]
    uidx_np = grid.universe_index(names)
    col_sel_np = grid.column_selector()
    uidx = torch.as_tensor(uidx_np, device=device)
    col_sel = torch.as_tensor(col_sel_np, device=device)
    window = torch.as_tensor(grid.window_masks(t), device=device)
    if row_weights is not None:
        row_weights = torch.as_tensor(row_weights, device=device).to(x.dtype)
        referee = False

    s_specs = len(grid)
    guard = _guard.guard_active()
    use_fact = False
    if factorize != "off" and procs == 1 and mesh is None:
        k_unique = int(unique_pairs(uidx_np, col_sel_np)[0].shape[0])
        # "auto" factorizes only when the grid repeats pairs (a window sweep)
        use_fact = factorize == "on" or k_unique < s_specs
    CONTRACTIONS["specs_solved"] += s_specs
    if use_fact:
        uidx_u, col_sel_u, pair_idx = unique_pairs(uidx_np, col_sel_np, pad_to=pair_pad)
        CONTRACTIONS["pairs_unique"] += k_unique
        CONTRACTIONS["pairs_contracted"] += int(uidx_u.shape[0])
        pair_stats = contract_spec_grams(
            y, x, universes, torch.as_tensor(uidx_u, device=device),
            torch.as_tensor(col_sel_u, device=device), None, firm_chunk=firm_chunk,
            row_weights=row_weights, precision=precision)
        stats = expand_window_stats(pair_stats, torch.as_tensor(pair_idx, device=device,
                                                                dtype=torch.long), window)
    elif mesh is not None:
        from fm_returnprediction_tpu_torch.specgrid.sharded import sharded_grid_parts

        CONTRACTIONS["specs_contracted"] += s_specs
        cs, fms, suspect, counters = sharded_grid_parts(
            y, x, tuple(universe_masks[nm] for nm in names), uidx, col_sel, window, mesh=mesh,
            row_weights=raw_rw, nw_lags=grid.nw_lags, min_months=grid.min_months,
            weights=tuple(weights), firm_chunk=firm_chunk, guard=guard)
    elif procs > 1:
        CONTRACTIONS["specs_contracted"] += s_specs
        merged = multiproc_grid_stats(
            y, x, tuple(universe_masks[nm] for nm in names), uidx_np, col_sel_np,
            grid.window_masks(t), procs=procs, row_weights=raw_rw, firm_chunk=firm_chunk,
            device=device.type)
        stats = SpecGramStats(*(torch.from_numpy(a).to(device) for a in merged))
    else:
        CONTRACTIONS["specs_contracted"] += s_specs
        stats = contract_spec_grams(y, x, universes, uidx, col_sel, window,
                                    firm_chunk=firm_chunk, row_weights=row_weights,
                                    precision=precision)
    if mesh is None:
        cs, fms, suspect, counters = _solve_and_aggregate(
            stats, col_sel, y.dtype, nw_lags=grid.nw_lags, min_months=grid.min_months,
            weights=tuple(weights), guard=guard, precision=precision,
        )
    if guard:
        _guard.record("specgrid.grid_program", counters)
    suspect_months = _host(suspect).sum(axis=1).astype(np.int64)
    flagged = [int(s) for s in np.nonzero(suspect_months > 0)[0]] if referee else []

    out: Dict[str, SpecGridResult] = {}
    # duplicate specs (the tile engine pads batches by repeating a spec)
    # share one referee solve
    referee_cache: Dict[tuple, tuple] = {}
    slopes0, intercept0, r20 = _host(cs.slopes), _host(cs.intercept), _host(cs.r2)
    n_obs0, month_valid0 = _host(cs.n_obs), _host(cs.month_valid)
    for w, fm in zip(weights, fms):
        slopes, intercept, r2 = slopes0.copy(), intercept0.copy(), r20.copy()
        n_obs, month_valid = n_obs0.copy(), month_valid0.copy()
        coef, tstat, nw_se = _host(fm.coef), _host(fm.tstat), _host(fm.nw_se)
        mean_r2, mean_n = _host(fm.mean_r2), _host(fm.mean_n)
        n_months = _host(fm.n_months)
        for s in flagged:
            spec = grid.specs[s]
            pos = grid.column_positions(spec)
            key = (w, spec.predictors, spec.universe, spec.window)
            cached = referee_cache.get(key)
            if cached is None:
                mask = universes[uidx[s]] & window[s][:, None]
                ref_cs, ref_fm = fama_macbeth(
                    y, x[:, :, pos], mask, nw_lags=grid.nw_lags,
                    min_months=grid.min_months, weight=w,
                )
                cached = referee_cache[key] = (
                    {k: _host(v) for k, v in ref_cs._asdict().items()},
                    {k: _host(v) for k, v in ref_fm._asdict().items()})
            ref_cs, ref_fm = cached
            slopes[s] = np.nan
            slopes[s][:, pos] = ref_cs["slopes"]
            intercept[s] = ref_cs["intercept"]
            r2[s] = ref_cs["r2"]
            n_obs[s] = ref_cs["n_obs"]
            month_valid[s] = ref_cs["month_valid"]
            coef[s] = np.nan
            coef[s][pos] = ref_fm["coef"]
            tstat[s] = np.nan
            tstat[s][pos] = ref_fm["tstat"]
            nw_se[s] = np.nan
            nw_se[s][pos] = ref_fm["nw_se"]
            mean_r2[s] = ref_fm["mean_r2"]
            mean_n[s] = ref_fm["mean_n"]
            n_months[s] = ref_fm["n_months"]
        out[w] = SpecGridResult(
            slopes, intercept, r2, n_obs, month_valid, coef, tstat, nw_se,
            mean_r2, mean_n, n_months, suspect_months.copy(), tuple(flagged),
        )
    return out


def run_spec_grid_on_panel(
    panel,
    subset_masks: Dict[str, torch.Tensor],
    grid: SpecGrid,
    return_col: str = "retx",
    referee: bool = True,
    firm_chunk=None,
    mesh=None,
    device=None,
) -> SpecGridResult:
    """``run_spec_grid`` with ``y`` (the ``return_col`` column) and the
    union predictor columns sliced from a ``DensePanel``, and only the
    universes the grid names kept from ``subset_masks``. The panel's values
    stay on their device when they are a tensor; host values move to
    ``device`` (None means the card), and so do the masks."""
    values = panel.values
    dev = values.device if isinstance(values, torch.Tensor) else resolve_device(device)
    y = torch.as_tensor(panel.var(return_col), device=dev).contiguous()
    x = torch.as_tensor(panel.select(grid.union_predictors), device=dev).contiguous()
    needed = set(grid.universe_names)
    masks = {n: torch.as_tensor(m, device=dev) for n, m in subset_masks.items() if n in needed}
    return run_spec_grid(y, x, masks, grid, referee=referee, firm_chunk=firm_chunk, mesh=mesh)
