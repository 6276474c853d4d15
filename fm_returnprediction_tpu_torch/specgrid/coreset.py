"""Coreset panel compression — sampled-and-reweighted Gram contraction.

The approximation tier beside the exact gram route (coresets for
regressions with panel data): when even the shared-design contraction is too
expensive — the per-tile cost is O(S·T·N·Q²) in the panel width N — solve
each cell on a row-SAMPLED, importance-REWEIGHTED panel instead. Per month,
``m`` rows are drawn with replacement with probability proportional to a
ridge-leverage proxy (the squared row norm of the standardized design plus
one — rows far from the center carry more of the Gram and must be kept more
often), and each drawn row enters the weighted contraction with weight
``count / (m · p)``. That makes the weighted Gram/moment/count sums
UNBIASED estimators of the full-sample sufficient statistics, with relative
error ~1/√m on well-spread months; months with fewer valid rows than ``m``
are left exact (weight 1 on every valid row — no noise where sampling buys
nothing).

This is a DISCLOSED approximation tier: every cell solved through it
carries ``route="coreset"``, the per-month draw budget ``coreset_m`` and
its realized per-cell sampling rate in the result frame, and the QR referee
is disabled (it would re-solve on the full panel and splice two estimands —
``solve.run_spec_grid_weights`` enforces that). Only the scenario engine
(``specgrid.engine``) takes the route; Table 2 and Figure 1 never do.

Everything here is host-side numpy: sampling happens once per sweep (not
per cell), is deterministic in ``seed``, and the output is just the
``row_weights`` tensor ``grams.contract_spec_grams`` consumes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

__all__ = ["CoresetPlan", "coreset_plan", "resolve_coreset_m"]


class CoresetPlan(NamedTuple):
    """The sampling disclosure the engine attaches to every coreset cell."""

    row_weights: np.ndarray     # (T, N) float; 0 = row not in the coreset
    m_per_month: int            # draw budget per month
    sampled: np.ndarray         # (T, N) bool: row carries weight > 0
    valid: np.ndarray           # (T, N) bool: row was eligible (finite y)
    exact_months: int           # months left unsampled (valid <= m)

    def rate_under(self, universe_mask: np.ndarray,
                   window: Optional[np.ndarray] = None) -> float:
        """Realized sampling rate for one cell: distinct sampled rows over
        eligible rows, averaged over the cell's window months."""
        elig = self.valid & np.asarray(universe_mask, bool)
        took = self.sampled & elig
        if window is not None:
            elig = elig & np.asarray(window, bool)[:, None]
            took = took & np.asarray(window, bool)[:, None]
        per_month_elig = elig.sum(axis=1)
        months = per_month_elig > 0
        if not months.any():
            return float("nan")
        rates = took.sum(axis=1)[months] / per_month_elig[months]
        return float(rates.mean())


def resolve_coreset_m(n_firms: int, m_per_month: Optional[int] = None,
                      budget_mb: Optional[float] = None,
                      t: int = 1, q: int = 2,
                      itemsize: int = 4) -> int:
    """The per-month draw budget: explicit ``m_per_month`` wins; otherwise
    size it so one (T, m, Q) weighted-design temporary fits ``budget_mb``
    (the same dominant temporary ``grams.auto_firm_chunk`` budgets);
    otherwise default to ~¼ of the panel width. Clamped to [64, n_firms]."""
    if m_per_month is None:
        if budget_mb is not None:
            per_row = max(t * q * itemsize, 1)
            m_per_month = int(budget_mb * 2**20) // per_row
        else:
            m_per_month = n_firms // 4
    return int(max(64, min(m_per_month, n_firms)))


def coreset_plan(y, x, mask, m_per_month: int, seed: int = 0) -> CoresetPlan:
    """Build the per-month importance-sampling plan for the panel.

    ``y`` (T, N), ``x`` (T, N, P), ``mask`` (T, N). Eligibility is
    ``mask ∧ finite(y)`` — spec-level column validity varies per cell and
    is still enforced exactly inside the weighted contraction (a sampled
    row with a non-finite selected column contributes zero there, same as
    the exact route). Sensitivities: ``s_i = 1 + ‖z_i‖²`` on the per-month
    standardized design with non-finite entries at the center (z = 0) —
    the standard ridge-leverage upper-bound proxy; sampling is multinomial
    with replacement, weights ``count_i / (m · p_i)``.
    """
    y = np.asarray(y)
    x = np.asarray(x)
    mask = np.asarray(mask, bool)
    t, n = y.shape
    rng = np.random.default_rng(seed)

    valid = mask & np.isfinite(y)
    fin = np.isfinite(x)
    xz = np.where(fin, x, 0.0)
    cnt = np.maximum(fin.sum(axis=1, keepdims=True), 1)
    mean = xz.sum(axis=1, keepdims=True) / cnt
    var = (np.where(fin, x - mean, 0.0) ** 2).sum(axis=1, keepdims=True) / cnt
    z = np.where(fin, (x - mean) / np.sqrt(np.maximum(var, 1e-12)), 0.0)
    sens = 1.0 + (z ** 2).sum(axis=-1)           # (T, N)

    weights = np.zeros((t, n), dtype=np.float64)
    sampled = np.zeros((t, n), dtype=bool)
    exact_months = 0
    for ti in range(t):
        rows = np.nonzero(valid[ti])[0]
        if rows.size == 0:
            continue
        if rows.size <= m_per_month:
            # sampling cannot shrink this month — keep it exact
            weights[ti, rows] = 1.0
            sampled[ti, rows] = True
            exact_months += 1
            continue
        p = sens[ti, rows]
        p = p / p.sum()
        counts = rng.multinomial(m_per_month, p)
        took = counts > 0
        weights[ti, rows[took]] = counts[took] / (m_per_month * p[took])
        sampled[ti, rows[took]] = True
    return CoresetPlan(weights, int(m_per_month), sampled, valid,
                       exact_months)
