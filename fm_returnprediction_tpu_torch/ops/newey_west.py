"""Newey-West standard error of a time-series mean.

Keeps the reference's NON-textbook Bartlett weight ``w_k = 1 − k/T``, where
``T`` is the number of valid months in the series (the textbook kernel
``1 − k/(L+1)`` is available behind ``weight="textbook"``). The reference
computes NW on ``.dropna()``'d slope series — autocovariance lag k pairs
ADJACENT SURVIVING months — so valid entries are compacted to the front
(stable chronological order) before lagged products are formed.

``clustered_mean_se`` is the estimator family's ``se="cluster"`` kernel: the
cluster-robust standard error of the same mean, by calendar blocks
(``specgrid.estimators.cluster.fm_cluster_summary``). Its cluster sums are
one product with the (T, G) cluster indicator, so they come out in the same
order on every run (no atomics).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["compact_front", "nw_mean_se", "nw_mean_se_np", "clustered_mean_se",
           "clustered_mean_se_np"]


def compact_front(x: torch.Tensor, valid: torch.Tensor):
    """Stable-partition the last axis so valid entries come first in
    original order. Returns (compacted values with the invalid tail
    zeroed, count of valid)."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    n = valid.sum(dim=-1)
    ramp = torch.arange(x.shape[-1], device=x.device)
    xc = torch.gather(x, -1, order)
    xc = torch.where(ramp < n[..., None], xc, torch.zeros_like(xc))
    return xc, n


def nw_mean_se(x: torch.Tensor, valid: torch.Tensor, lags: int = 4,
               weight: str = "reference") -> torch.Tensor:
    """NW standard error for the mean of the valid entries of each series
    along the last axis.

    ``var(mean) = (γ₀ + 2 Σ_{k=1..L} w_k γ_k) / n²`` with
    ``γ_k = Σ_i u_i u_{i-k}`` over demeaned compacted values. Series with
    fewer than 2 valid entries give NaN.
    """
    xc, n = compact_front(x, valid)
    nf = n.to(xc.dtype)
    in_range = torch.arange(xc.shape[-1], device=xc.device) < n[..., None]
    mean = torch.where(n > 0, xc.sum(dim=-1) / torch.clamp_min(nf, 1.0),
                       torch.zeros_like(nf))
    u = torch.where(in_range, xc - mean[..., None], torch.zeros_like(xc))

    gamma0 = (u * u).sum(dim=-1)
    acc = torch.zeros_like(gamma0)
    for k in range(1, lags + 1):
        if k < u.shape[-1]:
            gamma_k = (u[..., k:] * u[..., :-k]).sum(dim=-1)
        else:
            gamma_k = torch.zeros_like(gamma0)
        if weight == "reference":
            w = torch.clamp_min(1.0 - k / torch.clamp_min(nf, 1.0), 0.0)
        elif weight == "textbook":
            w = 1.0 - k / (lags + 1.0)
        else:
            raise ValueError(f"Unknown NW weight scheme: {weight}")
        acc = acc + w * gamma_k

    var_mean = (gamma0 + 2.0 * acc) / torch.clamp_min(nf, 1.0) ** 2
    return torch.where(n >= 2, torch.sqrt(var_mean),
                       torch.full_like(var_mean, float("nan")))


def clustered_mean_se(x: torch.Tensor, valid: torch.Tensor,
                      cluster_ids: torch.Tensor) -> torch.Tensor:
    """Cluster-robust standard error for the mean of the valid entries of
    each series along the last axis:

        var(mean) = (Σ_g S_g²) / n²,   S_g = Σ_{i∈g} (x_i − x̄)

    over the valid entries, with ``cluster_ids`` (T,) the CALENDAR grouping
    of the series' slots (``month // 12`` for by-year blocks), ids in
    [0, T). All within-cluster covariance counts and none across clusters.
    Fewer than 2 valid entries give NaN; the variance is a sum of squares
    and never negative."""
    valid = valid.to(torch.bool)
    dtype = x.dtype
    t = x.shape[-1]
    nf = valid.sum(dim=-1).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    mean = torch.where(valid, x, zero).sum(dim=-1) / torch.clamp_min(nf, 1.0)
    mean = torch.where(nf > 0, mean, zero)
    u = torch.where(valid, x - mean[..., None], zero)
    ids = torch.as_tensor(cluster_ids, device=x.device).to(torch.int64)
    onehot = (ids[:, None] == torch.arange(t, device=x.device)[None, :]).to(dtype)
    s_g = u @ onehot                                    # (..., T) cluster sums
    var_mean = (s_g * s_g).sum(dim=-1) / torch.clamp_min(nf, 1.0) ** 2
    return torch.where(nf >= 2, torch.sqrt(var_mean),
                       torch.full_like(var_mean, float("nan")))


def clustered_mean_se_np(vals: np.ndarray, clusters: np.ndarray) -> float:
    """Numpy mirror of :func:`clustered_mean_se` on an already-compacted
    valid series with its cluster labels, the host oracle."""
    vals = np.asarray(vals, float)
    clusters = np.asarray(clusters)
    n = vals.size
    if n < 2:
        return float("nan")
    u = vals - vals.mean()
    s_g = np.array([u[clusters == g].sum() for g in np.unique(clusters)])
    return float(np.sqrt((s_g ** 2).sum() / n ** 2))


def nw_mean_se_np(vals: np.ndarray, lags: int = 4, weight: str = "reference") -> float:
    """Numpy mirror of :func:`nw_mean_se` on an ALREADY-compacted valid
    series, the host oracle of the backtest's inference. Fewer than 2
    entries give NaN, and so does a negative small-sample HAC variance."""
    vals = np.asarray(vals, float)
    n = vals.size
    if n < 2:
        return float("nan")
    u = vals - vals.mean()
    gamma0 = float(u @ u)
    acc = 0.0
    for k in range(1, lags + 1):
        gamma_k = float(u[k:] @ u[:-k]) if k < n else 0.0
        if weight == "reference":
            w = max(1.0 - k / n, 0.0)
        elif weight == "textbook":
            w = 1.0 - k / (lags + 1.0)
        else:
            raise ValueError(f"Unknown NW weight scheme: {weight}")
        acc += w * gamma_k
    var_mean = (gamma0 + 2.0 * acc) / n**2
    return float(np.sqrt(var_mean)) if var_mean >= 0 else float("nan")
