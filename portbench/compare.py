"""Small measures of the gap between an answer and the reference's.

Every measure is a largest gap over its entries, so a number stays a worst
case; a non-finite answer where the reference is finite, or the reverse,
reads as infinite.
"""

from __future__ import annotations

import math

import numpy as np


def _pair(got, ref):
    g = np.asarray(got, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    if g.shape != r.shape:
        raise ValueError(f"shapes differ: {g.shape} vs {r.shape}")
    return g, r


def nan_mismatch(got, ref) -> int:
    """Entries finite on one side only."""
    g, r = _pair(got, ref)
    return int((np.isfinite(g) != np.isfinite(r)).sum())


def scaled_gap(got, ref, scale) -> float:
    """max |got − ref| / scale over entries finite on both sides (``scale``
    broadcasts); infinite where the finite patterns differ."""
    g, r = _pair(got, ref)
    if nan_mismatch(g, r):
        return math.inf
    both = np.isfinite(g) & np.isfinite(r)
    if not both.any():
        return 0.0
    s = np.broadcast_to(np.asarray(scale, dtype=np.float64), r.shape)
    return float(np.max(np.abs(g - r)[both] / s[both]))


def rel_gap(got, ref) -> float:
    """max |got − ref| / |ref|."""
    _, r = _pair(got, ref)
    return scaled_gap(got, ref, np.abs(r))


def column_scale(ref) -> float:
    """The spread of the reference's finite entries (standard deviation)."""
    r = np.asarray(ref, dtype=np.float64)
    return float(np.nanstd(np.where(np.isfinite(r), r, np.nan)))


def fm_gaps(coef, tstat, se, ref) -> tuple:
    """``(coef, tstat, se)`` gaps of one FM summary against the reference's
    ``ref`` (``coef``, ``tstat``, ``nw_se``, ``iid_se``), each measured where
    it is well conditioned. A Newey-West variance can cancel to a small part
    of the lag-0 variance, and then its relative error, and the t-statistic's,
    grow by that ratio in any precision; so the coefficient's gap is in units
    of the iid standard error, the variance's gap in units of the iid
    variance, and the t-statistic's relative gap is weighted by the
    variance's share of the iid variance."""
    c_r, t_r = ref.coef.cpu().numpy(), ref.tstat.cpu().numpy()
    se_r, iid = ref.nw_se.cpu().numpy(), ref.iid_se.cpu().numpy()
    se_p = np.asarray(se, dtype=np.float64)
    share = np.minimum(1.0, (se_r / iid) ** 2)
    return (scaled_gap(coef, c_r, iid),
            scaled_gap(np.asarray(tstat, np.float64) * share, t_r * share,
                       np.maximum(np.abs(t_r), 1.0)),
            scaled_gap(se_p * se_p, se_r * se_r, iid * iid))
