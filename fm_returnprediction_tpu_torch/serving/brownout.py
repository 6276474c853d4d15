"""Brownout: a disclosed degradation ladder for the serving fleet.

When load outruns capacity the fleet's plain answer is to shed (429). The
repo also owns cheaper-but-honest routes (the spec-grid's coreset route
and its bf16 contraction both trade disclosed precision for compute), and
this module brings the same stance to serving: instead of refusing
requests outright, the fleet walks a LADDER of degraded routes —

    full ──▶ (bf16) ──▶ coreset-m ──▶ shed

- **full**      — the normal path: microbatcher → bucketed executor.
- **bf16**      — the same projection with the clipped features and the
  slopes rounded to bfloat16 and the dot accumulated in f32; optional
  rung, off the default ladder.
- **coreset-m** — the projection restricted to each month's ``m``
  largest-``|slope|`` predictors, with a per-month error BOUND disclosed on
  every response (``Σ_dropped |slope|·max(|lo|,|hi|)``: the clip support
  caps each dropped term).
- **shed**      — the last rung: admission refuses with a typed retriable
  429 (``reason="brownout_shed"``).

The degraded rungs are answered on the HOST, from the frozen
``ServingState`` arrays, by design: they bypass the saturated
microbatcher and the device path entirely, so the congested resource gets
no new work, queues drain, the SLO burn falls, and the controller
recovers hysteretically (``recover_ticks`` calm ticks per rung up). That
is the reference's semantics, not a fallback from the card. Every
degraded response is a :class:`DegradedQuote`, a ``float`` subclass
carrying its route and precision.

The bf16 rounding goes through ``torch.bfloat16`` (round to nearest even,
as the reference's ``ml_dtypes`` rounding), so both packages give the
same bits.

The controller only ENGAGES after scale-out is exhausted (the supervisor
passes ``scale_exhausted``): elasticity first, degradation second, shed
last. Knobs: ``FMRP_FLEET_BROWNOUT`` (arm with env defaults),
``FMRP_FLEET_BROWNOUT_LADDER``, ``FMRP_FLEET_BROWNOUT_BURN``,
``FMRP_FLEET_BROWNOUT_OCCUPANCY``, ``FMRP_FLEET_BROWNOUT_M``,
``FMRP_FLEET_BROWNOUT_DWELL_TICKS``, ``FMRP_FLEET_BROWNOUT_RECOVER_TICKS``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "RUNG_FULL",
    "RUNG_BF16",
    "RUNG_CORESET",
    "RUNG_SHED",
    "BrownoutPolicy",
    "BrownoutController",
    "DegradedQuote",
    "degraded_project",
]

RUNG_FULL = "full"
RUNG_BF16 = "bf16"
RUNG_CORESET = "coreset"
RUNG_SHED = "shed"
_RUNGS = (RUNG_FULL, RUNG_BF16, RUNG_CORESET, RUNG_SHED)

_BF16_NAME = "bf16"


def _round_bf16(a: np.ndarray) -> np.ndarray:
    """f32 → bfloat16 → f32, round to nearest even."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


class DegradedQuote(float):
    """A quote served by a degraded route — still a ``float`` (existing
    callers keep working), plus the disclosure the route owes:

    route      : the ladder rung that answered ("bf16" / "coreset").
    precision  : the arithmetic actually used ("bf16" inputs / "f32").
    m          : coreset size (None off the coreset rung).
    err_bound  : |full − degraded| upper bound from the dropped slopes and
                 the clip support (None when the rung is exact-formula,
                 e.g. bf16 where only rounding differs).
    """

    __slots__ = ("route", "precision", "m", "err_bound")

    def __new__(cls, value, route: str, precision: str,
                m: Optional[int] = None,
                err_bound: Optional[float] = None):
        self = super().__new__(cls, value)
        self.route = route
        self.precision = precision
        self.m = m
        self.err_bound = err_bound
        return self

    @property
    def degraded(self) -> bool:
        return True

    def disclosure(self) -> dict:
        return {
            "route": self.route,
            "precision": self.precision,
            "m": self.m,
            "err_bound": self.err_bound,
        }


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """When does the fleet step down (and back up) the ladder?

    ladder           : rung names, outermost first; must start "full" and
        end "shed" (the controller's level indexes into it).
    enter_burn       : worst replica SLO burn at/above which a tick counts
        as pressure (2.0 = the default breach burn).
    exit_burn        : burn at/below which a tick counts as relief.
    enter_occupancy / exit_occupancy : aggregate queue occupancy twins.
    dwell_ticks      : pressure ticks (with scale-out exhausted) required
        before stepping DOWN one rung — flap damping on the way in.
    recover_ticks    : consecutive relief ticks required before stepping
        UP one rung — the hysteresis that stops a half-recovered fleet
        oscillating between rungs.
    coreset_m        : predictors kept on the coreset rung (None = half,
        rounded up, at compute time).
    shed_retry_after_s : the shed rung's retry-after hint.
    """

    ladder: Tuple[str, ...] = (RUNG_FULL, RUNG_CORESET, RUNG_SHED)
    enter_burn: float = 2.0
    exit_burn: float = 1.0
    enter_occupancy: float = 0.85
    exit_occupancy: float = 0.5
    dwell_ticks: int = 2
    recover_ticks: int = 3
    coreset_m: Optional[int] = None
    shed_retry_after_s: float = 0.05

    def __post_init__(self):
        if len(self.ladder) < 2 or self.ladder[0] != RUNG_FULL:
            raise ValueError("ladder must start at 'full' with ≥1 rung below")
        if self.ladder[-1] != RUNG_SHED:
            raise ValueError("ladder must end at 'shed' (the last resort)")
        for rung in self.ladder[1:-1]:
            if rung not in (RUNG_BF16, RUNG_CORESET):
                # 'full'/'shed' mid-ladder would invert the degradation
                # order (or hard-error every request on that rung)
                raise ValueError(
                    f"interior rung {rung!r} must be one of "
                    f"{(RUNG_BF16, RUNG_CORESET)}"
                )
        if len(set(self.ladder)) != len(self.ladder):
            raise ValueError(f"duplicate rungs in ladder {self.ladder}")
        if self.coreset_m is not None and self.coreset_m < 1:
            raise ValueError("coreset_m must be >= 1 (or None for ⌈P/2⌉)")
        if self.exit_burn > self.enter_burn:
            raise ValueError("exit_burn above enter_burn would oscillate")
        if self.exit_occupancy > self.enter_occupancy:
            raise ValueError(
                "exit_occupancy above enter_occupancy would oscillate"
            )

    @classmethod
    def from_env(cls, environ=None) -> "BrownoutPolicy":
        """FMRP_FLEET_BROWNOUT_{LADDER,BURN,OCCUPANCY,M,DWELL_TICKS,
        RECOVER_TICKS} over the defaults (exit thresholds derive as half
        the enter thresholds when only the enter side is set)."""
        env = os.environ if environ is None else environ
        kw: dict = {}
        ladder = env.get("FMRP_FLEET_BROWNOUT_LADDER")
        if ladder:
            kw["ladder"] = tuple(
                s.strip() for s in ladder.split(",") if s.strip()
            )
        burn = env.get("FMRP_FLEET_BROWNOUT_BURN")
        if burn:
            kw["enter_burn"] = float(burn)
            kw["exit_burn"] = float(burn) / 2.0
        occ = env.get("FMRP_FLEET_BROWNOUT_OCCUPANCY")
        if occ:
            kw["enter_occupancy"] = float(occ)
            kw["exit_occupancy"] = float(occ) / 2.0
        m = env.get("FMRP_FLEET_BROWNOUT_M")
        if m:
            kw["coreset_m"] = int(m)
        dwell = env.get("FMRP_FLEET_BROWNOUT_DWELL_TICKS")
        if dwell:
            kw["dwell_ticks"] = int(dwell)
        recover = env.get("FMRP_FLEET_BROWNOUT_RECOVER_TICKS")
        if recover:
            kw["recover_ticks"] = int(recover)
        return cls(**kw)


class BrownoutController:
    """The ladder's state machine. Driven by the supervisor's tick (one
    ``update`` per tick, pure function of the signals it is handed — no
    clocks, no randomness), read by the fleet's submit path
    (``active_rung``). Thread-safe: submit reads race ticks."""

    def __init__(self, policy: Optional[BrownoutPolicy] = None):
        self.policy = policy or BrownoutPolicy.from_env()
        self.level = 0              # index into policy.ladder
        self._hot = 0               # consecutive pressure-while-exhausted
        self._cool = 0              # consecutive relief ticks
        self._lock = threading.Lock()
        self.degraded_served = 0    # responses answered below "full"
        # per-(state,m) coreset cache: keep-mask + error bound per month.
        # Keyed by id() WITH a strong ref to the state held in the value,
        # so the id cannot be recycled while the entry lives; bounded FIFO.
        self._coreset_cache: Dict[tuple, tuple] = {}

    # -- read side (fleet submit path) -------------------------------------

    @property
    def active(self) -> bool:
        return self.level > 0

    def active_rung(self) -> Optional[str]:
        """The current degraded rung name, or None at full service."""
        level = self.level
        return self.policy.ladder[level] if level > 0 else None

    # -- control side (supervisor tick) ------------------------------------

    def update(self, *, burn: float, occupancy: float,
               scale_exhausted: bool) -> Optional[str]:
        """One tick of the ladder machine; returns the action taken
        ("brownout:<rung>" stepping down, "recover:<rung>" stepping up)
        or None. Pressure only walks the ladder DOWN while scale-out is
        exhausted — elasticity first, degradation second."""
        pol = self.policy
        pressure = burn >= pol.enter_burn or occupancy >= pol.enter_occupancy
        relief = burn <= pol.exit_burn and occupancy <= pol.exit_occupancy
        # Recovery is deliberately a PROBE: while a degraded rung serves,
        # the bypass suppresses the very signals that would prove the
        # overload abated, so the only way to learn is to step up a rung
        # and watch. Under genuinely sustained overload the ladder
        # therefore cycles up-rung → re-pressure → down-rung at a period
        # of recover_ticks + dwell_ticks — bounded, tunable exposure, by
        # design (contrast the autoscaler, which GATES relief scale-in on
        # the ladder being idle: un-spawning capacity is expensive to
        # reverse; stepping a rung back down is free).
        with self._lock:
            if pressure and scale_exhausted:
                self._cool = 0
                self._hot += 1
                if (self._hot >= pol.dwell_ticks
                        and self.level < len(pol.ladder) - 1):
                    self.level += 1
                    self._hot = 0
                    return f"brownout:{pol.ladder[self.level]}"
            elif relief:
                self._hot = 0
                self._cool += 1
                if self._cool >= pol.recover_ticks and self.level > 0:
                    self.level -= 1
                    self._cool = 0
                    return f"recover:{pol.ladder[self.level]}"
            else:
                # between thresholds (or pressure the autoscaler is still
                # absorbing): hold the rung, restart both streaks
                self._hot = 0
                self._cool = 0
        return None

    # -- the degraded compute ----------------------------------------------

    def _coreset(self, state, m: int):
        """(keep_mask (T,P), err_bound (T,)) for ``state`` at coreset size
        ``m`` — computed once per (state, m), cached with a strong ref so
        the id key stays valid for the entry's lifetime."""
        key = (id(state), int(m))
        hit = self._coreset_cache.get(key)
        if hit is not None:
            return hit[1], hit[2]
        keep, bound = _keep_and_bound(
            state.slopes_bar, state.x_lo, state.x_hi, m
        )
        with self._lock:
            if key not in self._coreset_cache:
                if len(self._coreset_cache) >= 4:
                    self._coreset_cache.pop(next(iter(self._coreset_cache)))
                self._coreset_cache[key] = (state, keep, bound)
        return keep, bound

    def answer(self, state, month_idx: int, x, rung: str) -> DegradedQuote:
        """One degraded quote, host-side. Mirrors ``er_project``'s
        answerability: NaN when the row has a non-finite predictor or the
        month carries no lagged coefficient mean."""
        m = self.policy.coreset_m
        if m is None:
            m = _default_m(state)
        quote = degraded_project(
            state, month_idx, x, rung, m=m,
            coreset=self._coreset if rung == RUNG_CORESET else None,
        )
        with self._lock:
            self.degraded_served += 1
        return quote


def _default_m(state) -> int:
    """The one home for "coreset_m=None means ⌈P/2⌉" — the controller
    and the direct ``degraded_project`` path must agree or the same
    disclosure would mean two different coreset sizes."""
    return max(1, (state.n_predictors + 1) // 2)


def _keep_and_bound(slopes, x_lo, x_hi, m: int):
    """THE coreset selection + bound, one home for both call paths (the
    controller's per-state cache and ``degraded_project``'s uncached
    fallback — a divergence would make the same disclosure mean two
    different things). ``(keep (T,P), err_bound (T,))`` over a (T,P)
    slope matrix: keep each month's ``m`` largest-``|slope|`` columns;
    every served feature clips into [x_lo, x_hi], so a dropped column's
    contribution is bounded by ``|slope|·max(|lo|,|hi|)`` — non-finite
    support (no data) propagates to an inf bound, an honest "unbounded"
    disclosure rather than a silent zero."""
    slopes = np.asarray(slopes, dtype=np.float64)
    t, p = slopes.shape
    mag = np.where(np.isfinite(slopes), np.abs(slopes), 0.0)
    keep = np.zeros((t, p), dtype=bool)
    if m >= p:
        keep[:] = True
    else:
        top = np.argpartition(mag, p - m, axis=1)[:, p - m:]
        np.put_along_axis(keep, top, True, axis=1)
    span = np.maximum(
        np.abs(np.asarray(x_lo, np.float64)),
        np.abs(np.asarray(x_hi, np.float64)),
    )
    # a zero-slope dropped column contributes exactly 0 even against an
    # unbounded (inf) support — 0·inf would otherwise poison the month's
    # bound with NaN (and warn); only dropped columns with real weight
    # inherit the inf-as-unbounded disclosure
    drop = np.where(~keep, mag, 0.0)
    with np.errstate(invalid="ignore"):
        bound = np.where(drop > 0.0, drop * span, 0.0).sum(axis=1)
    return keep, bound


def degraded_project(state, month_idx: int, x, rung: str,
                     m: Optional[int] = None, coreset=None) -> DegradedQuote:
    """The host-side degraded projection (numpy; no batcher, no device).

    Same formula as the serving kernel — clip to the month's fitted
    support, dot with the lagged slope means, add the intercept — with the
    rung's disclosed approximation: bf16-rounded inputs (f32 accumulate)
    on the bf16 rung; the month's ``m`` largest-``|slope|`` predictors
    only on the coreset rung. ``coreset`` is an optional cached
    ``(state, m) -> (keep, bound)`` provider (the controller's)."""
    if rung not in (RUNG_BF16, RUNG_CORESET):
        raise ValueError(f"no degraded projection for rung {rung!r}")
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    slopes = np.asarray(state.slopes_bar[month_idx], dtype=np.float32)
    intercept = float(state.intercept_bar[month_idx])
    ok = (
        bool(np.all(np.isfinite(x)))
        and np.all(np.isfinite(slopes))
        and np.isfinite(intercept)
    )
    if not ok:
        return DegradedQuote(
            np.nan, route=rung,
            precision=_BF16_NAME if rung == RUNG_BF16 else "f32",
            m=m if rung == RUNG_CORESET else None,
        )
    lo = np.asarray(state.x_lo[month_idx], dtype=np.float32)
    hi = np.asarray(state.x_hi[month_idx], dtype=np.float32)
    xb = np.clip(x, lo, hi)
    if rung == RUNG_BF16:
        xb = _round_bf16(xb)
        slopes = _round_bf16(slopes)
        er = intercept + float(np.dot(xb, slopes))
        return DegradedQuote(er, route=RUNG_BF16, precision=_BF16_NAME)
    if m is None:
        m = _default_m(state)
    if coreset is not None:
        keep, bound = coreset(state, m)
        keep_row = keep[month_idx]
        err_bound = float(bound[month_idx])
    else:
        keep, bound = _keep_and_bound(slopes[None, :], lo[None, :],
                                      hi[None, :], m)
        keep_row = keep[0]
        err_bound = float(bound[0])
    er = intercept + float(np.dot(np.where(keep_row, xb, 0.0), slopes))
    return DegradedQuote(
        er, route=RUNG_CORESET, precision="f32",
        m=int(min(m, len(slopes))), err_bound=err_bound,
    )
