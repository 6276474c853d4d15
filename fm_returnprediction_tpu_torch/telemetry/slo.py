"""Declarative SLOs + a sliding-window monitor over the serving metrics.

The batcher's latency ring yields lifetime p50/p99; what it cannot
answer is *is the objective holding right now*: a cumulative ring pools
last hour's healthy samples into this minute's incident. This module is
the windowed view:

- an :class:`SLO` is a declarative objective: "no more than ``budget``
  of requests in the trailing ``window_s`` may be *bad*", where bad is
  either a failure (``kind="error_rate"``), a latency above
  ``threshold_ms`` (``kind="latency"`` — a classic "p99 < X" SLO is
  ``threshold_ms=X, budget=0.01``), or queue occupancy above a fraction
  (``kind="queue"``).
- :class:`SloMonitor` ingests per-request observations (the service's
  batcher feeds it), maintains one sliding window, and derives per-SLO
  **burn rate** (observed bad fraction ÷ budget) and **state**:
  ``ok`` (burn < ``warn_burn``), ``warn`` (< ``breach_burn``),
  ``breach`` (≥). Recovery is just the window draining — states are a
  pure function of the trailing window, so transitions are deterministic
  under an injected clock (unit-tested against a synthetic stream).

``ERService`` builds its monitor from explicit objectives or the
``FMRP_SLO_*`` env knobs (:func:`slos_from_env`), surfaces the state in
``stats()`` and as ``fmrp_slo_*`` gauges in ``/metrics``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "SLO",
    "SloMonitor",
    "slos_from_env",
    "STATE_OK",
    "STATE_WARN",
    "STATE_BREACH",
    "STATE_CODES",
]

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_BREACH = "breach"
#: numeric encoding for Prometheus gauges (alerts key off >=1 / >=2)
STATE_CODES = {STATE_OK: 0, STATE_WARN: 1, STATE_BREACH: 2}

_KINDS = ("latency", "error_rate", "queue")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective over the trailing window.

    ``budget`` is the allowed bad fraction (0.01 = 1%); ``threshold_ms``
    only applies to ``kind="latency"`` (a request slower than it is bad)
    and, reinterpreted as an occupancy fraction in (0, 1], to
    ``kind="queue"``, whose burn is CONTINUOUS — occupancy over the
    ceiling — so pick ``warn_burn``/``breach_burn`` on that scale (the
    env-armed default warns at 0.8× the ceiling, breaches at it)."""

    name: str
    kind: str = "latency"
    threshold_ms: Optional[float] = None
    budget: float = 0.01
    warn_burn: float = 1.0
    breach_burn: float = 2.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"SLO kind must be one of {_KINDS}, got {self.kind!r}")
        if self.kind in ("latency", "queue") and self.threshold_ms is None:
            raise ValueError(f"SLO {self.name!r}: {self.kind} needs threshold_ms")
        if not 0 < self.budget <= 1:
            raise ValueError(f"SLO {self.name!r}: budget must be in (0, 1]")
        if self.breach_burn < self.warn_burn:
            raise ValueError(
                f"SLO {self.name!r}: breach_burn < warn_burn would make "
                "the warn state unreachable"
            )


class SloMonitor:
    """Sliding-window burn-rate evaluation of a set of :class:`SLO`\\ s.

    ``clock`` is injectable (monotonic seconds) so tests drive the
    window deterministically; production uses ``time.monotonic``."""

    def __init__(
        self,
        objectives: Tuple[SLO, ...],
        window_s: float = 60.0,
        max_samples: int = 65536,
        clock=time.monotonic,
    ) -> None:
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.objectives = tuple(objectives)
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        # (t, latency_s or nan, ok) — one deque, bounded: a flood beyond
        # max_samples ages out oldest-first, same shape as the batcher ring
        self._samples: deque = deque(maxlen=max_samples)
        self._queue_frac = 0.0  # latest queue occupancy (gauge-style)

    # -- ingestion ---------------------------------------------------------

    def observe(self, latency_s: Optional[float], ok: bool = True,
                now: Optional[float] = None) -> None:
        """One finished request: its latency (None for a request that
        never produced one, e.g. a backpressure reject) and whether it
        succeeded."""
        t = self._clock() if now is None else now
        lat = float("nan") if latency_s is None else float(latency_s)
        with self._lock:
            self._samples.append((t, lat, bool(ok)))

    def observe_queue(self, occupancy_fraction: float) -> None:
        """Latest queue occupancy (depth / max_queue), a point-in-time
        gauge rather than a windowed sample."""
        with self._lock:
            self._queue_frac = float(occupancy_fraction)

    # -- evaluation --------------------------------------------------------

    def _window(self, now: float) -> List[tuple]:
        cutoff = now - self.window_s
        with self._lock:
            # drop aged-out samples so a long-lived service's memory and
            # evaluation cost stay bounded by traffic, not uptime
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            return list(self._samples)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Window stats + per-objective burn/state + the overall worst
        state. Deterministic given the sample stream and ``now``."""
        now = self._clock() if now is None else now
        window = self._window(now)
        lats = np.asarray(
            [s[1] for s in window if s[2] and s[1] == s[1]], dtype=np.float64
        )
        n = len(window)
        n_bad = sum(1 for s in window if not s[2])
        out: dict = {
            "window_s": self.window_s,
            "n": n,
            "error_rate": (n_bad / n) if n else 0.0,
            "p50_ms": float(np.percentile(lats, 50) * 1e3) if len(lats) else None,
            "p99_ms": float(np.percentile(lats, 99) * 1e3) if len(lats) else None,
            "qps": n / self.window_s,
            "queue_occupancy": self._queue_frac,
        }
        worst = STATE_OK
        objectives: Dict[str, dict] = {}
        for slo in self.objectives:
            if slo.kind == "error_rate":
                bad_frac = out["error_rate"]
            elif slo.kind == "latency":
                thresh_s = slo.threshold_ms / 1e3
                slow = sum(
                    1 for s in window if (not s[2]) or s[1] > thresh_s
                )
                bad_frac = (slow / n) if n else 0.0
            else:  # queue: continuous exceedance, not a binary trip — a
                # binary bad_frac caps burn at 1/budget and can leave the
                # breach threshold unreachable no matter how saturated
                # the queue is
                bad_frac = (
                    self._queue_frac / slo.threshold_ms
                    if slo.threshold_ms > 0 else 0.0
                )
            burn = bad_frac / slo.budget
            if burn >= slo.breach_burn:
                state = STATE_BREACH
            elif burn >= slo.warn_burn:
                state = STATE_WARN
            else:
                state = STATE_OK
            objectives[slo.name] = {
                "kind": slo.kind,
                "bad_fraction": bad_frac,
                "burn_rate": burn,
                "state": state,
                "state_code": STATE_CODES[state],
            }
            if STATE_CODES[state] > STATE_CODES[worst]:
                worst = state
        out["objectives"] = objectives
        out["state"] = worst
        out["state_code"] = STATE_CODES[worst]
        return out

    def worst_burn(self, now: Optional[float] = None) -> float:
        """The hottest objective's burn rate (0.0 with no objectives): the
        one-number pressure signal of the snapshot."""
        snap = self.snapshot(now=now)
        burns = [o["burn_rate"] for o in snap["objectives"].values()]
        return max(burns) if burns else 0.0


def slos_from_env(environ=None) -> Tuple[SLO, ...]:
    """Objectives from the ``FMRP_SLO_*`` knobs (empty tuple when none
    are set — the service then runs without a monitor):

    - ``FMRP_SLO_P99_MS``      → latency SLO, 1% budget ("p99 < X ms");
    - ``FMRP_SLO_P50_MS``      → latency SLO, 50% budget;
    - ``FMRP_SLO_ERROR_RATE``  → error-rate SLO with that budget;
    - ``FMRP_SLO_QUEUE``       → queue-occupancy ceiling (fraction);
    - ``FMRP_SLO_WINDOW_S``, ``FMRP_SLO_WARN_BURN``,
      ``FMRP_SLO_BREACH_BURN`` tune the latency/error objectives above.
      The QUEUE objective is excluded: its burn is occupancy/ceiling
      (bounded by 1/ceiling, a different scale from fraction-of-budget
      burns), so it pins warn=0.8×/breach=1× the ceiling — construct an
      explicit :class:`SLO` to tune it.
    """
    env = os.environ if environ is None else environ
    warn = float(env.get("FMRP_SLO_WARN_BURN", "1.0"))
    breach = float(env.get("FMRP_SLO_BREACH_BURN", "2.0"))
    out: List[SLO] = []
    p99 = env.get("FMRP_SLO_P99_MS")
    if p99:
        out.append(SLO("p99_latency", "latency", threshold_ms=float(p99),
                       budget=0.01, warn_burn=warn, breach_burn=breach))
    p50 = env.get("FMRP_SLO_P50_MS")
    if p50:
        out.append(SLO("p50_latency", "latency", threshold_ms=float(p50),
                       budget=0.50, warn_burn=warn, breach_burn=breach))
    err = env.get("FMRP_SLO_ERROR_RATE")
    if err:
        out.append(SLO("error_rate", "error_rate", budget=float(err),
                       warn_burn=warn, breach_burn=breach))
    queue = env.get("FMRP_SLO_QUEUE")
    if queue:
        # occupancy is bounded by 1.0, so the shared burn thresholds
        # (warn=1, breach=2) would make breach unreachable for any
        # ceiling above 0.5: the queue objective gets its own scale —
        # warn at 80% of the ceiling, breach at the ceiling itself
        out.append(SLO("queue_occupancy", "queue",
                       threshold_ms=float(queue), budget=1.0,
                       warn_burn=0.8, breach_burn=1.0))
    return tuple(out)


def env_window_s(environ=None) -> float:
    env = os.environ if environ is None else environ
    return float(env.get("FMRP_SLO_WINDOW_S", "60"))
