"""Newey-West standard error of a time-series mean.

Keeps the reference's NON-textbook Bartlett weight ``w_k = 1 − k/T``, where
``T`` is the number of valid months in the series (the textbook kernel
``1 − k/(L+1)`` is available behind ``weight="textbook"``). The reference
computes NW on ``.dropna()``'d slope series — autocovariance lag k pairs
ADJACENT SURVIVING months — so valid entries are compacted to the front
(stable chronological order) before lagged products are formed.
"""

from __future__ import annotations

import torch

__all__ = ["compact_front", "nw_mean_se"]


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
