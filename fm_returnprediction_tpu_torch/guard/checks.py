"""Numerical sentinels for the OLS, Fama-MacBeth and Gram-solve paths.

The silent numerical failures the contract layer cannot see from the host
— a Gram contraction overflowing to ``inf``, a month whose solve went
non-finite, a design whose conditioning ate the answer — happen inside the
device computations. The sentinels here are small integer reductions over
the (S, T) and (T, P) results those computations already hold:

- with the guard layer off the counter helpers are never called, so the
  unguarded path computes no extra tensor and its numbers are the guarded
  path's bit for bit;
- with it on, each counter stays a device tensor when it is recorded (no
  host wait on the hot path); :func:`drain` folds every pending counter
  with one stacked device-to-host copy when the audit record is assembled;
- each guarded entry point records under its own site name. A call that
  folds an inner solve into its own accounting (``fama_macbeth`` over
  ``monthly_cs_ols``, the forecast fits) asks the inner solve not to
  record, so the sites an audit lists are those of the outermost calls.

The switch is ``FMRP_GUARD`` (default on; ``off``/``0``/``false``/``no``
disables), overridable per block via :func:`guards` and ``run_pipeline``'s
``guard=``.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import threading
from typing import Dict

import numpy as np
import torch

__all__ = [
    "guard_active",
    "guards",
    "set_guard",
    "record",
    "record_cs_host",
    "record_fm_host",
    "drain",
    "counters",
    "reset",
    "nonfinite_count",
    "cs_counters",
    "fm_counters",
    "cond_limit",
]


def _env_default() -> bool:
    raw = os.environ.get("FMRP_GUARD", "on").strip().lower()
    return raw not in ("off", "0", "false", "no")


_ENABLED: bool = _env_default()
_LOCK = threading.Lock()
# (site, {counter_name: count}) pairs; a count may be a device tensor,
# folded by drain(). Bounded: record() folds eagerly past _PENDING_CAP so a
# long guarded run does not hold device tensors without end.
_PENDING: list = []
_PENDING_CAP = 1024
_COUNTERS: collections.Counter = collections.Counter()


def guard_active() -> bool:
    """Whether the numerical sentinels are armed."""
    return _ENABLED


def set_guard(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


@contextlib.contextmanager
def guards(enabled: bool):
    """Force the sentinels on or off for a block (``run_pipeline``'s
    ``guard=`` uses this)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    try:
        yield
    finally:
        _ENABLED = prev


# -- the audit accumulator -------------------------------------------------


def record(site: str, values: Dict[str, object]) -> None:
    """Queue one guarded call's counters under ``site``. ``values`` maps
    counter name → count (a 0-d tensor on any device, or an int)."""
    with _LOCK:
        _PENDING.append((site, values))
        overflow = len(_PENDING) >= _PENDING_CAP
    if overflow:
        drain()


def record_cs_host(site: str, cs) -> None:
    """Host-side solve sentinel over a ``CSRegressionResult`` with numpy
    leaves (extra leading batch axes allowed)."""
    if not guard_active():
        return
    valid = np.asarray(cs.month_valid)
    bad = np.any(~np.isfinite(np.asarray(cs.slopes)), axis=-1) | ~np.isfinite(
        np.asarray(cs.intercept)
    )
    record(site, {
        "nonfinite_solve_months": int((valid & bad).sum()),
        "nonfinite_r2_months": int((valid & ~np.isfinite(np.asarray(cs.r2))).sum()),
    })


def record_fm_host(site: str, fm) -> None:
    """Host-side NW tap over a ``FamaMacbethSummary`` with numpy leaves
    (same counting rule as :func:`fm_counters`: INFINITE t-stats only)."""
    if not guard_active():
        return
    record(site, {"infinite_tstat_cols": int(np.isinf(np.asarray(fm.tstat)).sum())})


def _fold(pending) -> list:
    """Every pending count as a Python int: the tensor counts of each
    device cross to the host in one stacked copy."""
    flat = [v for _, values in pending for v in values.values()]
    by_device: Dict[torch.device, list] = {}
    for i, v in enumerate(flat):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
    out = [int(v) if not isinstance(v, torch.Tensor) else 0 for v in flat]
    for idx in by_device.values():
        pulled = torch.stack([flat[i].reshape(()).to(torch.int64) for i in idx]).cpu()
        for i, count in zip(idx, pulled.tolist()):
            out[i] = count
    return out


def drain() -> Dict[str, int]:
    """Fold every pending record into the process counters and return a
    snapshot. Keys are ``"<site>.<name>"``; zero counts are dropped — the
    audit record lists violations, not visits."""
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    if pending:
        counts = iter(_fold(pending))
        fresh: Dict[str, int] = {}
        with _LOCK:
            for site, values in pending:
                for name in values:
                    count = next(counts)
                    if count:
                        key = f"{site}.{name}"
                        _COUNTERS[key] += count
                        fresh[key] = fresh.get(key, 0) + count
        if fresh:
            # mirror into the process metrics registry so the trips export
            # with every other counter (_COUNTERS stays the audit's source)
            from fm_returnprediction_tpu_torch.telemetry import event, registry

            for key, count in fresh.items():
                registry().counter(
                    "fmrp_guard_sentinel_total",
                    help="numerical sentinel trips by site.counter",
                    sentinel=key,
                ).inc(count)
                event("guard.sentinel", cat="guard", sentinel=key, count=count)
    with _LOCK:
        return dict(_COUNTERS)


def counters() -> Dict[str, int]:
    """Snapshot of the accumulated sentinel counters (drains first)."""
    return drain()


def reset() -> None:
    """Clear pending records and accumulated counters (test isolation)."""
    with _LOCK:
        _PENDING[:] = []
        _COUNTERS.clear()


# -- counter helpers (called only when the guard layer is on) --------------


def cond_limit(dtype: torch.dtype) -> float:
    """The shared conditioning threshold: ``1/sqrt(eps)`` of the compute
    dtype — beyond it a Gram/QR solve has lost half the mantissa."""
    return 1.0 / math.sqrt(float(torch.finfo(dtype).eps))


def nonfinite_count(x: torch.Tensor) -> torch.Tensor:
    """Number of non-finite entries of ``x`` (overflow/poison sentinel)."""
    return (~torch.isfinite(x)).sum()


def cs_counters(cs) -> Dict[str, torch.Tensor]:
    """Sentinels over a ``CSRegressionResult``: months that RAN but whose
    solve or R² came back non-finite (a month skipped for thinness is
    legal and not counted)."""
    valid = cs.month_valid
    bad_solve = (~torch.isfinite(cs.slopes)).any(dim=-1) | ~torch.isfinite(cs.intercept)
    return {
        "nonfinite_solve_months": (valid & bad_solve).sum(),
        "nonfinite_r2_months": (valid & ~torch.isfinite(cs.r2)).sum(),
    }


def fm_counters(fm) -> Dict[str, torch.Tensor]:
    """Sentinel over a ``FamaMacbethSummary`` (the NW-path tap): INFINITE
    t-stats — a zero long-run variance, i.e. a degenerate slope series.
    NaN t-stats are not counted: a negative small-sample HAC variance
    estimate legally yields NaN (the reference's blank cell)."""
    return {"infinite_tstat_cols": torch.isinf(fm.tstat).sum()}
