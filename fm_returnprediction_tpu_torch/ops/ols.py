"""Masked batched cross-sectional OLS (the QR solver).

One batched solve over the dense ``(T, N, P)`` panel replaces a per-month
loop of OLS fits:

- complete-case row validity (regressand and all predictors finite);
- months with fewer valid rows than ``P + 1`` regressors are skipped;
- slopes, intercept, centered cross-sectional R² and the per-month row
  count are returned for every month with a validity flag.

The solver QR-compresses each month's ``[X | y]`` to its small R factor and
solves the compressed system by SVD least squares with the cutoff pinned to
the global row count: ``RᵀR = [X|y]ᵀ[X|y]`` gives ``‖R_xβ − r_y‖ = ‖Xβ − y‖``
for every β, so the compressed minimum-norm solution is the global one and
``cond(R_x) = cond(X)`` (no condition-number squaring).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CSRegressionResult", "NormalStats", "row_validity",
           "augment_design", "sufficient_stats", "lstsq_min_norm",
           "monthly_cs_ols"]


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


def monthly_cs_ols(y: torch.Tensor, x: torch.Tensor,
                   mask: torch.Tensor) -> CSRegressionResult:
    """Every month's cross-sectional regression in one batched call.

    y (T, N) returns; x (T, N, P) lagged predictors; mask (T, N) bool row
    exists. Invalid months carry zeros and ``month_valid=False``; a month
    that ran with a non-finite solve keeps its NaNs for the FM layer to
    drop.
    """
    valid = row_validity(y, x, mask)
    n = valid.sum(dim=-1)
    p_aug = x.shape[-1] + 1
    x_aug, y_z, v = augment_design(y, x, valid)
    month_valid = n >= p_aug

    m = torch.cat([x_aug, y_z[..., None]], dim=-1)
    r = torch.linalg.qr(m, mode="r").R
    rcond = torch.finfo(x.dtype).eps * max(x.shape[-2], p_aug)
    beta = lstsq_min_norm(r[..., :-1], r[..., -1], rcond)
    beta = torch.where(month_valid[:, None], beta, torch.zeros_like(beta))

    resid = (y_z - (x_aug @ beta[..., None])[..., 0]) * v
    sse = (resid * resid).sum(dim=-1)
    ybar = torch.where(n > 0, y_z.sum(dim=-1) / torch.clamp_min(n, 1),
                       torch.zeros_like(sse))
    sst = (v * (y_z - ybar[:, None]) ** 2).sum(dim=-1)
    r2 = torch.where(sst > 0, 1.0 - sse / torch.where(sst > 0, sst, torch.ones_like(sst)),
                     torch.zeros_like(sst))
    r2 = torch.where(month_valid, r2, torch.zeros_like(r2))
    return CSRegressionResult(beta[:, 1:], beta[:, 0], r2, n, month_valid)
