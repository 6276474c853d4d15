"""Incremental month ingest: append a cross-section without a refit.

The batch fit is a pure function of per-month quantities: each month's OLS
depends only on that month's cross-section, and the lagged rolling
coefficient means depend only on strictly prior surviving months
(``models.forecast``). Appending a month at the end of the calendar
therefore touches exactly one new row of everything:

- the new month's slopes come from its additive normal-equation sufficient
  statistics (``ops.ols.sufficient_stats`` → ``solve_from_stats``), so a
  month arriving in pieces merges: stats for disjoint row sets add
  elementwise;
- the new month's lagged rolling mean is recomputed from the stored
  surviving coefficient rows alone (the trailing ``window`` of them, NaN
  entries excluded per column, gated on ``min_periods``). It is computed
  whether or not the new month's own cross-section yields a coefficient
  row: the start-of-month quote is precisely a month with no realized
  returns yet (``fit_forecast_artifacts``'s ``fill_invalid`` semantics);
- every existing row of the state is carried over unchanged.

Appending more firms to the current last month re-solves that month from
the merged stats; its own lagged mean is untouched (it never sees its own
month), and no later months exist, so nothing else moves.

The incremental route solves from sufficient statistics (the "normal"
solver). A state built with ``solver="normal"`` matches a full normal-route
refit to machine precision; a ``"qr"``-built state's earlier months keep
their QR solutions, and only ingested months carry normal-route solutions.

The state stays host numpy. The month's statistics and solve run on the
device the caller names (``device=None`` means the GPU and raises without
one). The fault site ``serving.ingest``, where the cross-section mutators
``resilience.faults.poison_nan_flood`` and ``poison_scale_spike`` are
injected, sits on the serving front end (``ERService.ingest_month``),
before :func:`validate_cross_section`, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.guard import checks as _guard
from fm_returnprediction_tpu_torch.guard import contracts as _contracts
from fm_returnprediction_tpu_torch.ops.ols import (
    NormalStats,
    row_validity,
    solve_from_stats,
    sufficient_stats,
)
from fm_returnprediction_tpu_torch.resilience.errors import IngestRejectedError
from fm_returnprediction_tpu_torch.serving.state import _merge_bounds, _support_bounds

__all__ = ["ingest_month", "validate_cross_section"]


def validate_cross_section(state, y_new, x_new, mask_new, month=None, audit=None):
    """Gate a candidate ingest month before it can touch the state.

    Coerces to the state's dtype, evaluates
    ``guard.contracts.cross_section_rules`` and enforces its quarantine
    severities. Returns the coerced ``(y, x, mask)`` numpy triple or raises
    :class:`IngestRejectedError` naming the violated rule: mismatched
    lengths or width (``cs.shape``/``cs.length``), an all-NaN flood
    (``cs.nan_flood``; a thin month is legal and stays quotable), infinite
    realized returns (``cs.y_bounds``), magnitudes in f32-Gram-overflow
    territory (``cs.value_bounds``), and, when ``month`` is passed and is
    new, a cross-section bit-identical to the state's last month
    (``cs.stale_repeat``: a stuck upstream feed).

    ``audit`` (a ``guard.contracts.AuditRecord``) receives every violation.
    """
    x = np.asarray(x_new, dtype=state.dtype)
    y = np.asarray(y_new, dtype=state.dtype)
    mask = np.asarray(mask_new, dtype=bool)
    _contracts.enforce(
        _contracts.evaluate(_contracts.cross_section_rules(state, month=month), (y, x, mask)),
        audit=audit,
    )
    return y, x, mask


def _month_stats(y, x, mask, dtype, device) -> NormalStats:
    """One cross-section's additive sufficient statistics, computed on
    ``device`` (numpy leaves)."""
    y = torch.tensor(np.asarray(y, dtype=dtype), device=device)
    x = torch.tensor(np.asarray(x, dtype=dtype), device=device)
    mask = torch.tensor(np.asarray(mask, dtype=bool), device=device)
    stats = sufficient_stats(y, x, row_validity(y, x, mask))
    return NormalStats(*(leaf.cpu().numpy() for leaf in stats))


def _solve(stats: NormalStats, device):
    """One month's OLS from (numpy) sufficient statistics on ``device``
    → (coef row [intercept, slopes], month valid)."""
    slopes, intercept, _r2, _n, month_valid = solve_from_stats(
        NormalStats(*(torch.tensor(np.asarray(leaf), device=device) for leaf in stats)))
    row = torch.cat([intercept.reshape(1), slopes]).cpu().numpy()
    return row, bool(month_valid)


def _lagged_bar_row(coef, month_valid, window, min_periods, dtype):
    """The lagged rolling coefficient mean for a row appended after the
    given months: mean of the trailing ``window`` surviving rows, NaN
    entries excluded per column, gated on ``min_periods``
    (``rolling_over_valid_rows(..., row_lag=1)`` for the one new slot)."""
    surv = coef[month_valid]
    tail = surv[-window:] if len(surv) else surv
    finite = np.isfinite(tail)
    cnt = finite.sum(axis=0)
    total = np.where(finite, tail, 0.0).sum(axis=0)
    return np.where(cnt >= min_periods, total / np.maximum(cnt, 1), np.nan).astype(dtype)


def _support_row(x, mask, dtype):
    lo, hi = _support_bounds(torch.from_numpy(np.asarray(x, dtype=dtype)[None]),
                             torch.from_numpy(np.asarray(mask, dtype=bool)[None]))
    return lo[0].numpy(), hi[0].numpy()


def ingest_month(state, y_new, x_new, mask_new, month, device=None):
    """Append one month's cross-section to a ``ServingState``.

    y_new (N,) realized returns (all-NaN keeps the month coefficient-less:
    its quote needs only prior months' coefficients); x_new (N, P) lagged
    predictors; mask_new (N,) row exists; ``month`` the new month's label,
    strictly later than the state's last month (append-only) or equal to
    it, in which case the rows merge into that month by stats addition.
    The statistics and the solve run on ``device`` (default the GPU).

    Returns a new ``ServingState`` (states are frozen).
    """
    device = resolve_device(device)
    dtype = state.dtype
    x_new = np.asarray(x_new, dtype=dtype)
    if x_new.shape[-1] != state.n_predictors:
        raise ValueError(
            f"expected {state.n_predictors} predictors ({state.xvars}), "
            f"got {x_new.shape[-1]}"
        )
    stamp = np.datetime64(month, "ns")
    merge = state.n_months > 0 and stamp == state.months[-1]
    if state.n_months and not merge and stamp <= state.months[-1]:
        raise ValueError(
            f"ingest is append-only: {month!r} is not after {state.months[-1]!r}"
        )

    new = _month_stats(y_new, x_new, mask_new, dtype, device)
    if merge:
        last = tuple(leaf[-1] for leaf in (state.gram, state.moment, state.n_obs,
                                           state.ysum, state.yy))
        new = NormalStats(*[a + b for a, b in zip(last, new)])

    if _guard.guard_active():
        # post-contraction overflow sentinel: values that each pass the
        # bounds contract can still overflow the Gram products at the
        # state's dtype (f32: x² past 3.4e38); a non-finite statistic must
        # never be baked into the state
        bad = int((~np.isfinite(new.gram)).sum() + (~np.isfinite(new.moment)).sum())
        if bad:
            _guard.record("serving.ingest", {"gram_nonfinite_entries": bad})
            raise IngestRejectedError(
                f"[quarantine] cs.nonfinite_stats: {bad} non-finite "
                f"sufficient-statistic entries after contraction "
                f"(overflow or poisoned rows)"
            )
    coef_row, valid_row = _solve(new, device)

    if merge:
        months = state.months
        # the slot's lagged mean sees strictly prior months only, so a
        # merge leaves it untouched
        bar_for_slot = np.concatenate([state.intercept_bar[-1:], state.slopes_bar[-1]]).astype(dtype)
        lo_row, hi_row = _merge_bounds(state.x_lo[-1], state.x_hi[-1],
                                       *_support_row(x_new, mask_new, dtype))
    else:
        months = np.concatenate([state.months, np.asarray([stamp], dtype="datetime64[ns]")])
        # computed whether or not the new month's own cross-section yields
        # a coefficient row (fill_invalid semantics)
        bar_for_slot = _lagged_bar_row(state.coef, state.month_valid, state.window,
                                       state.min_periods, dtype)
        lo_row, hi_row = _support_row(x_new, mask_new, dtype)

    def _append(existing, row):
        row = np.asarray(row)[None].astype(existing.dtype)
        return np.concatenate([existing[:-1] if merge else existing, row])

    return dataclasses.replace(
        state,
        months=months,
        coef=_append(state.coef, coef_row),
        month_valid=_append(state.month_valid, valid_row),
        slopes_bar=_append(state.slopes_bar, bar_for_slot[1:]),
        intercept_bar=_append(state.intercept_bar, bar_for_slot[0]),
        x_lo=_append(state.x_lo, lo_row),
        x_hi=_append(state.x_hi, hi_row),
        gram=_append(state.gram, new.gram),
        moment=_append(state.moment, new.moment),
        n_obs=_append(state.n_obs, new.n),
        ysum=_append(state.ysum, new.ysum),
        yy=_append(state.yy, new.yy),
    )
