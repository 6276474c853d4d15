"""Replica supervision: health probes, breach detection, drain + replace,
and the ELASTICITY leg — an SLO-burn autoscaler feeding a brownout ladder.

The supervisor is the fleet's control loop. Each :meth:`Supervisor.tick`
probes every replica's OWN instrumentation — the dispatch-timeout rate
and quarantine count the service already maintains, and the SLO breach
state the telemetry layer already computes — and
walks breaching replicas through a small, explicit state machine::

    HEALTHY ──breach×grace──▶ DRAINING ──queue empty──▶ (close) ─┐
       ▲                         │ drain budget spent            │
       │                         ▼                               │
       │                       DEAD  ◀── probe raised / killed   │
       │                         │                               │
       └────── REPLACEMENT ◀─────┴───────────────────────────────┘

- HEALTHY replicas receive traffic (the router's inclusion rule).
- DRAINING replicas are excluded from routing but keep answering what
  they already queued; a replica that cannot drain inside
  ``drain_timeout_ticks`` is force-killed (its queue fails over — the
  fleet requeues, nothing is stranded).
- DEAD replicas (probe raised, flusher thread gone, chaos kill) are
  replaced immediately: the fleet spawns a fresh replica from the current
  state version via the registry warm pool (``warm_from_registry``), so
  a failover never pays a build at query time. (A replica DRAINING for
  scale-in is RETIRED instead — removed without a replacement.)

After the health machine, the tick runs the OVERLOAD-SURVIVAL legs over
one shared :class:`PressureSignals` reading (worst armed replica SLO
burn, aggregate queue occupancy, admission sheds since the last tick):

- **Autoscaler** (:class:`AutoscalePolicy`): pressure grows the replica
  set (``fleet.scale_out``, through the warm pool),
  sustained relief shrinks it (``fleet.scale_in`` — drains through the
  DRAINING machinery, then retires). Min/max bounds, a cooldown between
  actions (deterministic under the fleet's injected clock), and
  ``in_ticks`` consecutive-relief hysteresis on the way down.
- **Brownout** (``fleet.brownout``, :mod:`.brownout`): when pressure
  persists AFTER scale-out is exhausted (at ``max_replicas``), the
  degradation ladder steps down — disclosed cheaper routes before any
  shed — and recovers hysteretically when the burn subsides.

Determinism: ``tick()`` is synchronous and side-effect-complete — tests
drive the machine tick by tick; the only clock is the injectable one the
cooldown reads. ``start()`` arms the same loop on a daemon thread for
production use.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["HealthPolicy", "AutoscalePolicy", "PressureSignals",
           "Supervisor", "HEALTHY", "DRAINING", "DEAD", "STARTING"]

# replica lifecycle states (plain strings: they appear in stats()/journal)
STARTING = "starting"
HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """When is a replica unfit to serve?

    max_dispatch_timeout_rate : watchdog-failed dispatches per dispatched
        batch since the last probe; above this the runner is stalling
        (the executor's ``dispatch_timeout_s`` watchdog feeds the
        numerator).
    max_quarantined_months    : outstanding quarantined ingest months a
        replica may carry before it is considered poisoned.
    fail_on_slo_breach        : an armed SLO monitor reporting ``breach``
        (state code 2) counts as a health breach.
    consecutive_breaches      : probes in a row that must breach before
        the supervisor drains (flap damping; 1 = act immediately).
    drain_timeout_ticks       : ticks a DRAINING replica may hold unserved
        work before it is force-killed and failed over.
    """

    max_dispatch_timeout_rate: float = 0.05
    max_quarantined_months: int = 2
    fail_on_slo_breach: bool = True
    consecutive_breaches: int = 1
    drain_timeout_ticks: int = 5


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When does the fleet grow or shrink?

    min_replicas / max_replicas : hard bounds on HEALTHY replicas.
    cooldown_s    : seconds between scale actions (the flap damper; read
        from the supervisor's injectable clock, so tests advance a fake
        clock instead of sleeping).
    out_burn      : worst replica SLO burn at/above which a tick is
        pressure (1.0 = the budget is exactly spent — scale BEFORE the
        breach threshold the brownout ladder keys off).
    out_occupancy : aggregate queue occupancy pressure twin.
    out_on_shed   : any admission shed since the last tick also counts as
        pressure (the bluntest possible signal that capacity ran out).
    in_burn / in_occupancy : relief thresholds — BOTH must hold, with zero
        sheds, for a tick to count toward scale-in.
    in_ticks      : consecutive relief ticks before one replica retires
        (hysteresis: scale-in is cheap to defer, expensive to regret).
    step          : replicas added per scale-out action.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    cooldown_s: float = 30.0
    out_burn: float = 1.0
    out_occupancy: float = 0.6
    out_on_shed: bool = True
    in_burn: float = 0.25
    in_occupancy: float = 0.15
    in_ticks: int = 3
    step: int = 1

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if self.step < 1:
            raise ValueError("step must be >= 1")

    @classmethod
    def from_env(cls, environ=None) -> Optional["AutoscalePolicy"]:
        """FMRP_FLEET_MIN / FMRP_FLEET_MAX / FMRP_FLEET_COOLDOWN_S.
        Returns None — autoscaling off — unless at least one is set."""
        env = os.environ if environ is None else environ
        lo, hi = env.get("FMRP_FLEET_MIN"), env.get("FMRP_FLEET_MAX")
        cool = env.get("FMRP_FLEET_COOLDOWN_S")
        if not (lo or hi or cool):
            return None
        kw: dict = {}
        if lo:
            kw["min_replicas"] = int(lo)
        if hi:
            kw["max_replicas"] = int(hi)
        # reconcile whichever side was left to its DEFAULT: FMRP_FLEET_MIN=8
        # alone must mean "at least 8" (max follows), not a constructor
        # crash inside every fleet start against the default max of 4.
        # BOTH sides explicitly contradictory is an operator error and
        # stays loud (silently raising max would override a capacity cap).
        lo_v = kw.get("min_replicas", cls.min_replicas)
        hi_v = kw.get("max_replicas", cls.max_replicas)
        if hi_v < lo_v:
            if lo and hi:
                raise ValueError(
                    f"FMRP_FLEET_MIN={lo_v} > FMRP_FLEET_MAX={hi_v}: "
                    "contradictory autoscale bounds"
                )
            if hi:
                kw["min_replicas"] = hi_v  # only max set: min follows down
            else:
                kw["max_replicas"] = lo_v  # only min set: max follows up
        if cool:
            kw["cooldown_s"] = float(cool)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class PressureSignals:
    """One tick's shared overload reading (autoscaler + brownout input)."""

    burn: float        # worst armed replica SLO burn rate (0 unarmed)
    occupancy: float   # aggregate queue depth / ceiling over healthy
    shed_delta: int    # admission sheds since the previous tick
    healthy: int       # replicas the router would consider


class _ProbeState:
    """Per-replica bookkeeping between ticks (supervisor-private)."""

    __slots__ = ("last_timeouts", "last_batches", "breaches", "drain_ticks")

    def __init__(self) -> None:
        self.last_timeouts = 0
        self.last_batches = 0
        self.breaches = 0
        self.drain_ticks = 0


class Supervisor:
    """Drives the replica state machine over a :class:`ServingFleet`.

    The fleet owns the replicas and the mutations (decommission, kill,
    replace); the supervisor owns the POLICY — what the probe evidence
    means and when to act. ``tick()`` returns the list of actions taken
    as human-readable strings (also journaled by the fleet), so tests and
    the bench can assert exactly what supervision did.
    """

    def __init__(self, fleet, policy: Optional[HealthPolicy] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.policy = policy or HealthPolicy()
        # the elasticity leg: explicit policy, else the FMRP_FLEET_{MIN,
        # MAX,COOLDOWN_S} knobs, else off (tick runs the health machine
        # only — the pre-autoscaler fleet, unchanged)
        self.autoscale = (
            autoscale if autoscale is not None else AutoscalePolicy.from_env()
        )
        self._clock = clock
        # cooldown anchor: one cooldown in the past, so the FIRST scale
        # action needs no warm-up wait
        self._last_scale_t = (
            clock() - self.autoscale.cooldown_s if self.autoscale else 0.0
        )
        self._relief_ticks = 0
        self._last_shed_total = 0
        self._probe: Dict[str, _ProbeState] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.ticks = 0

    # -- shared overload signals -------------------------------------------

    def signals(self) -> PressureSignals:
        """One reading of the fleet's pressure evidence: worst armed
        replica SLO burn, aggregate queue occupancy, and the admission
        sheds since the PREVIOUS call (delta state lives here, so call
        once per tick)."""
        depth, ceiling, healthy = self.fleet._queue_snapshot()
        burn = 0.0
        for rid in list(self.fleet.replica_states()):
            rep = self.fleet.replica(rid)
            if rep is None or rep.state != HEALTHY:
                continue
            monitor = getattr(rep.service, "slo", None)
            if monitor is not None:
                try:
                    burn = max(burn, monitor.worst_burn())
                except Exception:  # noqa: BLE001 — a dead probe reads 0
                    continue
        shed_total = self.fleet.shed_total
        delta = shed_total - self._last_shed_total
        self._last_shed_total = shed_total
        return PressureSignals(
            burn=burn,
            occupancy=(depth / ceiling) if ceiling else 0.0,
            shed_delta=max(delta, 0),
            healthy=healthy,
        )

    # -- probes ------------------------------------------------------------

    def probe(self, rid: str) -> List[str]:
        """One replica's health verdict: a list of breach reasons (empty =
        fit). A probe that cannot even read ``stats()`` — or finds the
        flusher thread dead — reports the hardest breach, ``heartbeat``."""
        rep = self.fleet.replica(rid)
        if rep is None:
            return ["gone"]
        try:
            stats = rep.service.stats()
        except Exception as exc:  # noqa: BLE001 — a dead probe IS the signal
            return [f"heartbeat:stats-raised:{type(exc).__name__}"]
        thread = rep.service.batcher._thread
        if thread is not None and not thread.is_alive():
            return ["heartbeat:flusher-dead"]
        ps = self._probe.setdefault(rid, _ProbeState())
        breaches: List[str] = []
        timeouts = int(stats.get("dispatch_timeouts") or 0)
        batches = int(stats.get("n_batches") or 0)
        d_timeouts = timeouts - ps.last_timeouts
        d_batches = batches - ps.last_batches
        ps.last_timeouts, ps.last_batches = timeouts, batches
        if d_timeouts > 0:
            rate = d_timeouts / max(1, d_batches)
            if rate > self.policy.max_dispatch_timeout_rate:
                breaches.append(f"dispatch_timeout_rate:{rate:.3f}")
        quarantined = len(stats.get("quarantined_months") or ())
        if quarantined > self.policy.max_quarantined_months:
            breaches.append(f"quarantined_months:{quarantined}")
        if self.policy.fail_on_slo_breach and stats.get("slo_state") == "breach":
            breaches.append("slo_breach")
        return breaches

    # -- the control loop --------------------------------------------------

    def tick(self) -> List[str]:
        """One supervision pass over the whole fleet; returns the actions
        taken. Deterministic: no clocks, no randomness — state advances
        only by what the probes saw since the previous tick."""
        self.ticks += 1
        actions: List[str] = []
        for rid, state in self.fleet.replica_states().items():
            rep = self.fleet.replica(rid)
            retiring = rep is not None and rep.retire_on_drain
            if state == DEAD:
                if retiring:
                    # a scale-in victim that died draining leaves WITHOUT
                    # a replacement — the autoscaler asked for fewer
                    self.fleet.retire(rid, reason="dead while scaling in")
                    self._probe.pop(rid, None)
                    actions.append(f"retire:{rid}")
                else:
                    new_rid = self.fleet.replace(rid, reason="dead")
                    self._probe.pop(rid, None)
                    actions.append(f"failover:{rid}->{new_rid}")
            elif state == DRAINING:
                ps = self._probe.setdefault(rid, _ProbeState())
                if self.fleet.replica_idle(rid):
                    if retiring:
                        self.fleet.retire(rid, reason="scaled in")
                        self._probe.pop(rid, None)
                        actions.append(f"retire:{rid}")
                    else:
                        new_rid = self.fleet.replace(rid, reason="drained")
                        self._probe.pop(rid, None)
                        actions.append(f"replace:{rid}->{new_rid}")
                elif ps.drain_ticks >= self.policy.drain_timeout_ticks:
                    self.fleet.kill_replica(
                        rid, reason="drain budget exhausted"
                    )
                    actions.append(f"force-kill:{rid}")
                else:
                    ps.drain_ticks += 1
            elif state == HEALTHY:
                breaches = self.probe(rid)
                ps = self._probe.setdefault(rid, _ProbeState())
                if any(b.startswith("heartbeat") or b == "gone"
                       for b in breaches):
                    # no heartbeat = nothing left to drain politely
                    self.fleet.kill_replica(rid, reason=";".join(breaches))
                    actions.append(f"kill:{rid}:{breaches[0]}")
                elif breaches:
                    ps.breaches += 1
                    if ps.breaches >= self.policy.consecutive_breaches:
                        self.fleet.decommission(rid, reasons=breaches)
                        ps.drain_ticks = 0
                        actions.append(f"drain:{rid}:{';'.join(breaches)}")
                else:
                    ps.breaches = 0
        # the overload-survival legs share one signal reading per tick
        if self.autoscale is not None or self.fleet.brownout is not None:
            sig = self.signals()
            exhausted = self._autoscale(sig, actions)
            self._brownout(sig, exhausted, actions)
        return actions

    # -- the autoscaler leg ------------------------------------------------

    def _autoscale(self, sig: PressureSignals, actions: List[str]) -> bool:
        """Grow on pressure, shrink on sustained relief; returns whether
        scale-OUT is exhausted (at max, or no policy — the brownout
        ladder's precondition)."""
        pol = self.autoscale
        if pol is None:
            return True  # no elasticity: degradation is the only lever
        pressure = (
            sig.burn >= pol.out_burn
            or sig.occupancy >= pol.out_occupancy
            or (pol.out_on_shed and sig.shed_delta > 0)
        )
        ctl = self.fleet.brownout
        browned_out = ctl is not None and ctl.active
        relief = (
            not browned_out
            # under brownout the calm is an ARTIFACT: degraded requests
            # bypass the queues, so zero occupancy / decaying burn says
            # nothing about the offered load — retiring replicas now
            # would re-overload the moment the ladder recovers
            and sig.burn <= pol.in_burn
            and sig.occupancy <= pol.in_occupancy
            and sig.shed_delta == 0
        )
        # the max bound caps LIVE replicas (healthy + draining + not-yet-
        # replaced), not just healthy: a breach-draining replica plus a
        # pressure scale-out would otherwise overshoot the cap once the
        # drained one is replaced (max_replicas is a capacity/cost bound)
        live = len(self.fleet.replica_states())
        now = self._clock()
        cooled = (now - self._last_scale_t) >= pol.cooldown_s
        # scale verbs route through the topology controller when one is
        # attached, so elasticity updates the DECLARED shape (and its
        # journal topology mark) instead of drifting away from it
        scaler = getattr(self.fleet, "topology", None) or self.fleet
        if pressure:
            self._relief_ticks = 0
            if cooled and live < pol.max_replicas:
                n = min(pol.step, pol.max_replicas - live)
                rids = scaler.scale_out(
                    n,
                    reason=f"burn={sig.burn:.2f} occ={sig.occupancy:.2f} "
                           f"shed+={sig.shed_delta}",
                )
                self._last_scale_t = now
                actions.append(f"scale-out:+{len(rids)}:{','.join(rids)}")
                return False
        elif relief:
            self._relief_ticks += 1
            if (cooled and self._relief_ticks >= pol.in_ticks
                    and sig.healthy > pol.min_replicas):
                rid = scaler.scale_in(reason="sustained relief")
                if rid is not None:
                    self._last_scale_t = now
                    self._relief_ticks = 0
                    actions.append(f"scale-in:{rid}")
        else:
            self._relief_ticks = 0
        return live >= pol.max_replicas

    # -- the brownout leg --------------------------------------------------

    def _brownout(self, sig: PressureSignals, exhausted: bool,
                  actions: List[str]) -> None:
        ctl = self.fleet.brownout
        if ctl is None:
            return
        step = ctl.update(
            burn=sig.burn, occupancy=sig.occupancy, scale_exhausted=exhausted
        )
        self.fleet._note_brownout(step, ctl)
        if step is not None:
            actions.append(step)

    # -- background mode ---------------------------------------------------

    def start(self, interval_s: float) -> None:
        """Run ``tick()`` every ``interval_s`` on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — supervision must survive
                    pass  # a failed tick; the next one re-probes from scratch

        self._thread = threading.Thread(
            target=loop, name="fmrp-fleet-supervisor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
