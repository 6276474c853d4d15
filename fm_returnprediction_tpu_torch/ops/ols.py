"""Masked batched cross-sectional OLS.

One batched solve over the dense ``(T, N, P)`` panel replaces a per-month
loop of OLS fits:

- complete-case row validity (regressand and all predictors finite);
- months with fewer valid rows than ``P + 1`` regressors are skipped;
- slopes, intercept, centered cross-sectional R² and the per-month row
  count are returned for every month with a validity flag.

Three solvers, as in the reference package:

- ``"qr"`` (default) QR-compresses each month's ``[X | y]`` to its small R
  factor and solves the compressed system by SVD least squares with the
  cutoff pinned to the global row count: ``RᵀR = [X|y]ᵀ[X|y]`` gives
  ``‖R_xβ − r_y‖ = ‖Xβ − y‖`` for every β, so the compressed minimum-norm
  solution is the global one and ``cond(R_x) = cond(X)`` (no
  condition-number squaring);
- ``"lstsq"`` is the SVD minimum-norm solve on the zero-padded design
  itself (zero rows leave the singular values untouched);
- ``"normal"`` solves from the additive sufficient statistics
  (:func:`sufficient_stats` → :func:`solve_from_stats`, the Gram
  pseudo-inverse): the cheapest, but it squares the condition number.

With the guard layer on (``guard.checks``) ``monthly_cs_ols`` queues its
sentinel counters under ``"ols.monthly_cs_ols"``: non-finite solves and R²
on months that ran, non-finite Gram and moment entries (the normal route),
and months whose triangular condition proxy ``max|r_ii|/min|r_ii|``
exceeds ``1/sqrt(eps)`` (the QR route).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fm_returnprediction_tpu_torch.guard import checks as _guard

__all__ = ["CSRegressionResult", "NormalStats", "SOLVERS", "row_validity",
           "augment_design", "sufficient_stats", "gram_pinv",
           "solve_from_stats", "lstsq_min_norm", "monthly_cs_ols"]

SOLVERS = ("qr", "lstsq", "normal")


class CSRegressionResult(NamedTuple):
    """Batched per-month regression results."""

    slopes: torch.Tensor       # (T, P) slope per predictor
    intercept: torch.Tensor    # (T,)
    r2: torch.Tensor           # (T,) centered cross-sectional R²
    n_obs: torch.Tensor        # (T,) valid rows per month
    month_valid: torch.Tensor  # (T,) bool: month had >= P+1 valid rows


def row_validity(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Complete-case validity: row exists and regressand + all predictors
    are finite."""
    return mask & torch.isfinite(y) & torch.isfinite(x).all(dim=-1)


def augment_design(y: torch.Tensor, x: torch.Tensor, valid: torch.Tensor):
    """Masked design with the intercept column first: ``(x_aug, y_z, v)``
    where invalid rows are exact zeros."""
    v = valid.to(x.dtype)
    x_aug = torch.cat(
        [torch.ones_like(y)[..., None],
         torch.where(valid[..., None], x, torch.zeros_like(x))], dim=-1,
    )
    x_aug = x_aug * v[..., None]
    y_z = torch.where(valid, y, torch.zeros_like(y))
    return x_aug, y_z, v


class NormalStats(NamedTuple):
    """Normal-equation sufficient statistics for a batch of cross-sections:
    exactly the quantities that are ADDITIVE over disjoint firm subsets."""

    gram: torch.Tensor    # (..., Q, Q) XᵀX with intercept column, Q = P+1
    moment: torch.Tensor  # (..., Q)    Xᵀy
    n: torch.Tensor       # (...)       valid rows, in x's dtype
    ysum: torch.Tensor    # (...)       Σy over valid rows
    yy: torch.Tensor      # (...)       Σy² over valid rows


def sufficient_stats(y: torch.Tensor, x: torch.Tensor,
                     valid: torch.Tensor) -> NormalStats:
    """Contract a masked cross-section batch into normal-equation stats.
    Shapes: y (..., N), x (..., N, P), valid (..., N) bool. The products
    run at the dtype's full precision (no TF32)."""
    x_aug, y_z, v = augment_design(y, x, valid)
    gram = torch.einsum("...np,...nq->...pq", x_aug, x_aug)
    moment = torch.einsum("...np,...n->...p", x_aug, y_z)
    return NormalStats(gram, moment, v.sum(-1), y_z.sum(-1), (y_z * y_z).sum(-1))


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor, rcond: float) -> torch.Tensor:
    """Batched minimum-norm least squares by SVD: singular values below
    ``rcond`` times the largest are treated as zero (``numpy.linalg.lstsq``
    semantics). a (..., M, K), b (..., M) → (..., K)."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    utb = (u.transpose(-1, -2) @ b[..., None])[..., 0]
    return (vh.transpose(-1, -2) @ (s_inv * utb)[..., None])[..., 0]


def gram_pinv(stats: NormalStats):
    """Pseudo-inverse of the (safe) Gram matrices plus the month gate.

    A skipped month (``n < Q``) inverts the identity instead of its Gram.
    Singular values at or below ``10·Q·eps`` times the largest are dropped
    (the reference's ``pinv`` cutoff). A Gram with a non-finite entry has
    no singular value that passes the cutoff in the reference, whose
    pseudo-inverse is then zero (the month's R² comes out NaN, the solve
    sentinel sees a non-finite R²); torch's SVD would raise on it, so such
    a Gram is decomposed as the identity and its pseudo-inverse zeroed."""
    gram, n = stats.gram, stats.n
    q = gram.shape[-1]
    month_valid = n >= q
    eye = torch.eye(q, dtype=gram.dtype, device=gram.device)
    safe = torch.where(month_valid[..., None, None], gram, eye)
    finite = torch.isfinite(safe).all(dim=-1).all(dim=-1)
    safe = torch.where(finite[..., None, None], safe, eye)
    u, s, vh = torch.linalg.svd(safe, full_matrices=False)
    cutoff = 10.0 * q * torch.finfo(gram.dtype).eps * s[..., :1]
    s = torch.where(s > cutoff, s, torch.full_like(s, float("inf")))
    pinv = vh.transpose(-1, -2) @ (u.transpose(-1, -2) / s[..., None])
    pinv = torch.where(finite[..., None, None], pinv, torch.zeros_like(pinv))
    return pinv, month_valid


def solve_from_stats(stats: NormalStats):
    """Per-month OLS from sufficient statistics (the "normal" solver).

    Skipped months (``n < Q``) carry zero slopes and R² with
    ``month_valid=False``. R² is the centered one, rebuilt as 1 − SSE/SST
    with SSE = yᵀy − 2βᵀ(Xᵀy) + βᵀ(XᵀX)β. Returns ``(slopes (..., P),
    intercept (...), r2 (...), n (...), month_valid (...))``."""
    gram, moment, n, ysum, yy = stats
    pinv, month_valid = gram_pinv(stats)
    beta = (pinv @ moment[..., None])[..., 0]
    beta = torch.where(month_valid[..., None], beta, torch.zeros_like(beta))
    bg = (beta * (gram @ beta[..., None])[..., 0]).sum(dim=-1)
    bm = (beta * moment).sum(dim=-1)
    sse = yy - 2.0 * bm + bg
    sst = yy - ysum * ysum / torch.clamp_min(n, 1.0)
    r2 = torch.where(sst > 0, 1.0 - sse / torch.where(sst > 0, sst, torch.ones_like(sst)),
                     torch.zeros_like(sst))
    r2 = torch.where(month_valid, r2, torch.zeros_like(r2))
    return beta[..., 1:], beta[..., 0], r2, n, month_valid


def _guard_record(cs: CSRegressionResult, gram_nonfinite, cond_exceeded) -> None:
    zero = torch.zeros((), dtype=torch.int64, device=cs.slopes.device)
    _guard.record("ols.monthly_cs_ols", {
        **_guard.cs_counters(cs),
        "gram_nonfinite_entries": zero if gram_nonfinite is None else gram_nonfinite,
        "cond_exceeded_months": zero if cond_exceeded is None else cond_exceeded,
    })


def monthly_cs_ols(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                   solver: str = "qr", guard=None, record: bool = True) -> CSRegressionResult:
    """Every month's cross-sectional regression in one batched call.

    y (..., T, N) returns; x (..., T, N, P) lagged predictors; mask
    (..., T, N) bool row exists (leading axes broadcast, e.g. a stack of
    subset masks over one panel). Invalid months carry zeros and
    ``month_valid=False``; a month that ran with a non-finite solve keeps
    its NaNs for the FM layer to drop. ``solver`` is ``"qr"``, ``"lstsq"``
    or ``"normal"`` (module docstring); another name raises
    ``ValueError``. ``guard=None`` follows the guard layer's switch
    (``guard.checks``), ``True``/``False`` override it for this call; when
    armed and ``record`` is true the call's sentinel counters are queued. A
    caller that accounts for this solve itself (``fama_macbeth``, the
    forecast fits) passes ``record=False``.
    """
    if solver not in SOLVERS:
        raise ValueError(f"Unknown solver: {solver}")
    # torch.broadcast_shapes would import sympy on its first call (~3 s)
    y, mask = torch.broadcast_tensors(y, mask)
    x = x.expand(*y.shape, x.shape[-1])
    valid = row_validity(y, x, mask)
    guarded = record and (_guard.guard_active() if guard is None else bool(guard))
    if solver == "normal":
        stats = sufficient_stats(y, x, valid)
        cs = CSRegressionResult(*solve_from_stats(stats))
        if guarded:
            _guard_record(cs, _guard.nonfinite_count(stats.gram)
                          + _guard.nonfinite_count(stats.moment), None)
        return cs

    n = valid.sum(dim=-1)
    p_aug = x.shape[-1] + 1
    x_aug, y_z, v = augment_design(y, x, valid)
    month_valid = n >= p_aug
    rcond = torch.finfo(x.dtype).eps * max(x.shape[-2], p_aug)
    if solver == "qr":
        m = torch.cat([x_aug, y_z[..., None]], dim=-1)
        r = torch.linalg.qr(m, mode="r").R
        beta = lstsq_min_norm(r[..., :-1], r[..., -1], rcond)
    else:
        beta = lstsq_min_norm(x_aug, y_z, rcond)
    beta = torch.where(month_valid[..., None], beta, torch.zeros_like(beta))

    resid = (y_z - (x_aug @ beta[..., None])[..., 0]) * v
    sse = (resid * resid).sum(dim=-1)
    ybar = torch.where(n > 0, y_z.sum(dim=-1) / torch.clamp_min(n, 1),
                       torch.zeros_like(sse))
    sst = (v * (y_z - ybar[..., None]) ** 2).sum(dim=-1)
    r2 = torch.where(sst > 0, 1.0 - sse / torch.where(sst > 0, sst, torch.ones_like(sst)),
                     torch.zeros_like(sst))
    r2 = torch.where(month_valid, r2, torch.zeros_like(r2))
    cs = CSRegressionResult(beta[..., 1:], beta[..., 0], r2, n, month_valid)
    if guarded:
        cond_exceeded = None
        if solver == "qr":
            # triangular condition proxy: cond(R_x) >= max|r_ii| / min|r_ii|,
            # priced from the R factor the solve already computed
            rd = torch.diagonal(r[..., :-1], dim1=-2, dim2=-1).abs()
            proxy = rd.amax(dim=-1) / torch.clamp_min(rd.amin(dim=-1),
                                                      torch.finfo(x.dtype).tiny)
            cond_exceeded = (month_valid & (proxy > _guard.cond_limit(x.dtype))).sum()
        _guard_record(cs, None, cond_exceeded)
    return cs
