"""Resilient serving fleet: N supervised ``ERService`` replicas behind one
admission-controlled submit path.

A single ``ERService`` is one stalled bucket away from taking the whole
quoting path down. The fleet makes serving survive faults the service
alone only detects:

- **Replication + routing.** N replicas (each its own ``MicroBatcher`` and
  ``BucketedExecutor`` on its own warmed CUDA graphs, per-replica metric
  labels) behind a consistent hash ring; routing excludes draining and
  dead replicas, and a request whose replica dies mid-flight is REQUEUED
  on a healthy one, exactly once, as the journal proves
  (``serving.journal``).
- **Admission control.** A token bucket plus queue-occupancy load
  shedding in FRONT of the per-replica batchers turns backpressure
  (``QueueFullError``) into a typed, retriable
  :class:`~fm_returnprediction_tpu_torch.resilience.errors.ServiceOverloadError`
  (429-style) carrying retry-after hints.
- **Supervision + failover.** The :class:`~.supervisor.Supervisor` probes
  each replica's own instrumentation (dispatch-timeout rate, quarantine
  count, SLO breach) and walks breaching replicas through drain →
  replace; replacements start through the registry warm pool
  (``registry.warm_from_registry``) when one is armed, with their
  ``WarmReport`` kept per replica. A replica that leaves frees its
  graphs, their static buffers, its pinned staging and its state on the
  card (``ERService.release``).
- **Zero-downtime versioned rollover.** ``rollover(new_state)`` is a
  two-phase protocol: PREPARE warms the new version's executor on every
  replica (validation and the ``fleet.poison_state`` site gate the
  candidate), then COMMIT flips each replica; a failure anywhere in
  prepare aborts with ZERO flips, so the fleet never splits across
  versions.
- **The request journal.** Every request's lifecycle is journaled
  write-ahead; ``replay_journal`` proves zero dropped and zero duplicated
  across swaps and replica deaths.
- **Overload survival.** The supervisor's autoscaler leg
  (``supervisor.AutoscalePolicy``) grows the replica set under pressure
  and shrinks it on sustained relief; past the scale-out limit the
  brownout ladder (``serving.brownout``) answers through disclosed,
  cheaper host-side routes before it sheds. After a hard crash,
  :meth:`ServingFleet.recover` rebuilds the fleet from the journal and the
  registry with the in-flight requests closed out to typed retriable
  outcomes (``serving.recovery``). ``serving.loadgen`` drives all of it.

Fault sites (deterministic, ``resilience.faults``): ``fleet.replica_kill``
(kill the replica a request was just routed to), ``fleet.replica_stall``
(stall one replica's dispatches), ``fleet.poison_state`` (corrupt a
rollover candidate), ``fleet.swap_mid_flight`` (trigger a staged rollover
from inside the submit path), ``fleet.hard_crash`` (abandon the fleet the
way a process death would), ``fleet.journal_torn_tail`` (tear the
journal's final line as the handle drops).

Replicas are threads of this process or, with ``replica_mode="process"``
(``FMRP_FLEET_REPLICA_MODE``), spawned processes, each owning its own
``ERService`` and CUDA context behind the socket control plane and a
socket or shared-memory data plane (``FMRP_FLEET_TRANSPORT``;
``serving.replica_proc``, ``replica_worker``, ``shm``). A process replica
is spawned from the registry's warm pool when one is armed (its
``WarmReport`` rides back in the hello) and loads its state from a
``ServingState`` bundle on the filesystem. The journal stays with the
router, so the exactly-once replay survives a replica process SIGKILL;
the supervisor's stats probe is the wire heartbeat. Routing, admission,
rollover and recovery are the same code in both modes.

Knobs: ``FMRP_FLEET_SIZE`` (default replica count),
``FMRP_FLEET_REPLICA_MODE`` (``thread``/``process``),
``FMRP_FLEET_TRANSPORT`` (``auto``/``shm``/``socket``), ``FMRP_FLEET_RATE`` /
``FMRP_FLEET_BURST`` (admission token bucket), ``FMRP_FLEET_SHED_OCCUPANCY``
(queue-occupancy shed threshold), ``FMRP_FLEET_JOURNAL`` (journal path),
``FMRP_FLEET_JOURNAL_KEEP`` (rotated-session retention),
``FMRP_FLEET_PROBE_S`` (background supervisor cadence),
``FMRP_FLEET_{MIN,MAX,COOLDOWN_S}`` (autoscaler), ``FMRP_FLEET_BROWNOUT`` /
``FMRP_FLEET_BROWNOUT_*`` (degradation ladder); ``--fleet-size`` on the
command line.
"""

from __future__ import annotations

import bisect
import contextvars
import dataclasses
import hashlib
import math
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.telemetry import distributed as _obs
from fm_returnprediction_tpu_torch.telemetry import spans as _spans
from fm_returnprediction_tpu_torch.resilience.errors import (
    DispatchTimeoutError,
    IngestRejectedError,
    InjectedFault,
    ReplicaDeadError,
    ServiceOverloadError,
    StateRolloverError,
)
from fm_returnprediction_tpu_torch.resilience.faults import fault_site
from fm_returnprediction_tpu_torch.serving import brownout as _brownout
from fm_returnprediction_tpu_torch.serving.batcher import QueueFullError
from fm_returnprediction_tpu_torch.serving.brownout import (
    BrownoutController,
    BrownoutPolicy,
)
from fm_returnprediction_tpu_torch.serving.journal import (
    RequestJournal,
    replay_journal,
)
from fm_returnprediction_tpu_torch.serving.service import ERService
from fm_returnprediction_tpu_torch.serving.supervisor import (
    DEAD,
    DRAINING,
    HEALTHY,
    AutoscalePolicy,
    HealthPolicy,
    Supervisor,
)

__all__ = [
    "TokenBucket",
    "AdmissionPolicy",
    "HashRing",
    "ServingFleet",
    "fleet_smoke",
]

# inner-future failures the fleet requeues on another replica: each means
# "this replica failed the request", never "the request is malformed" —
# requeueing a poison-pill request would just serially crash the fleet,
# so ValueError/KeyError/... deliberately are NOT here. QueueFullError is
# here for the shm transport's optimistic accept: a replica-side
# backpressure reject arrives on the future there (thread and socket
# replicas raise it at submit, where _route_and_submit reroutes)
_REQUEUEABLE = (ReplicaDeadError, DispatchTimeoutError, InjectedFault,
                QueueFullError)


# -- admission control -------------------------------------------------------


class TokenBucket:
    """Deterministic token bucket (injectable clock — tests advance a fake
    clock instead of sleeping). ``try_acquire`` returns ``None`` when the
    token was granted, else the seconds until one will exist — the 429's
    retry-after hint, not a guess."""

    def __init__(self, rate_per_s: float, burst: float,
                 clock=time.monotonic):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("rate_per_s and burst must be > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> Optional[float]:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return None
            return (n - self._tokens) / self.rate


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The front tier's shed rules.

    rate_per_s / burst   : token bucket over admitted requests (None =
        no rate limit — occupancy shedding still applies).
    max_occupancy        : shed when aggregate pending requests across
        healthy replicas reach this fraction of their total ``max_queue``
        ceiling — the queue evidence rides the same fields
        ``QueueFullError`` now carries, one layer earlier.
    retry_after_floor_s  : minimum retry-after hint (a zero hint invites
        a tight retry storm).
    """

    rate_per_s: Optional[float] = None
    burst: float = 64.0
    max_occupancy: float = 0.9
    retry_after_floor_s: float = 0.005

    @classmethod
    def from_env(cls) -> "AdmissionPolicy":
        """FMRP_FLEET_RATE / FMRP_FLEET_BURST / FMRP_FLEET_SHED_OCCUPANCY
        (unset rate = no token bucket)."""
        rate = os.environ.get("FMRP_FLEET_RATE")
        burst = os.environ.get("FMRP_FLEET_BURST")
        occ = os.environ.get("FMRP_FLEET_SHED_OCCUPANCY")
        return cls(
            rate_per_s=float(rate) if rate else None,
            burst=float(burst) if burst else 64.0,
            max_occupancy=float(occ) if occ else 0.9,
        )


# -- consistent hash routing -------------------------------------------------


class HashRing:
    """Consistent hash ring with virtual nodes (sha256 points).

    Routing walks clockwise from the key's point and returns the first
    replica not excluded — so removing a replica only remaps the keys
    that hashed to it, and a draining/dead replica is skipped without
    disturbing everyone else's affinity. Deterministic: same members +
    same key → same route, every process, every run."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []  # sorted (hash, rid)
        self._lock = threading.Lock()

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")

    def add(self, rid: str) -> None:
        with self._lock:
            for v in range(self.vnodes):
                bisect.insort(self._points, (self._hash(f"{rid}#{v}"), rid))

    def remove(self, rid: str) -> None:
        with self._lock:
            self._points = [p for p in self._points if p[1] != rid]

    def members(self) -> Set[str]:
        with self._lock:
            return {rid for _, rid in self._points}

    def route(self, key: str, exclude: Set[str] = frozenset()
              ) -> Optional[str]:
        with self._lock:
            if not self._points:
                return None
            start = bisect.bisect_left(self._points, (self._hash(key), ""))
            seen: Set[str] = set()
            for k in range(len(self._points)):
                _, rid = self._points[(start + k) % len(self._points)]
                if rid in seen:
                    continue
                seen.add(rid)
                if rid not in exclude:
                    return rid
            return None


# -- replicas ----------------------------------------------------------------


class _ReplicaService(ERService):
    """An ``ERService`` that knows which replica it is. (The
    ``fleet.replica_stall`` fault site rides the executor's watchdogged
    dispatch, keyed by the ``replica`` metric label, so an injected stall
    is indistinguishable from a wedged device runner.)"""

    def __init__(self, state, replica_id: str = "r?", **kwargs):
        self.replica_id = replica_id
        super().__init__(state, **kwargs)


class _Replica:
    """Fleet-side record for one replica (state guarded by the fleet
    lock; ``inflight`` counts requests routed but not yet resolved)."""

    __slots__ = ("rid", "service", "state", "inflight", "generation",
                 "reasons", "folded", "retire_on_drain")

    def __init__(self, rid: str, service: ERService, generation: int):
        self.rid = rid
        self.service = service
        self.state = HEALTHY
        self.inflight = 0
        self.generation = generation
        self.reasons: List[str] = []
        self.folded = False  # final counters folded into the fleet prior
        self.retire_on_drain = False  # scale-in: drain then LEAVE, no spawn


# -- the fleet ---------------------------------------------------------------


class ServingFleet:
    """N supervised ``ERService`` replicas behind one admission-controlled
    submit path. See the module docstring for the full story; the public
    surface mirrors ``ERService`` (``submit``/``query``/``query_many``/
    ``stats``/``prometheus_metrics``/``close``) plus the fleet verbs
    (``rollover``, ``kill_replica``, ``decommission``, ``replace``,
    ``supervisor.tick``)."""

    def __init__(
        self,
        state,
        n_replicas: Optional[int] = None,
        *,
        admission: Optional[AdmissionPolicy] = None,
        health: Optional[HealthPolicy] = None,
        autoscale: Optional[AutoscalePolicy] = None,
        brownout=None,
        registry_dir=None,
        journal=None,
        max_requeues: int = 2,
        vnodes: int = 64,
        probe_interval_s: Optional[float] = None,
        admission_clock=time.monotonic,
        replica_mode: Optional[str] = None,
        transport: Optional[str] = None,
        **service_kwargs,
    ):
        if n_replicas is None:
            n_replicas = int(os.environ.get("FMRP_FLEET_SIZE", "2"))
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if replica_mode is None:
            replica_mode = os.environ.get(
                "FMRP_FLEET_REPLICA_MODE", "thread"
            ).strip().lower() or "thread"
        if replica_mode not in ("thread", "process"):
            raise ValueError(
                f"replica_mode {replica_mode!r} is not 'thread'|'process'")
        self.replica_mode = replica_mode
        # process replicas' data plane: "shm" rings or the "socket"
        # (serving.shm.resolve_fleet_transport, resolved per spawn)
        self._transport = transport
        self._proc_scratch = None
        if replica_mode == "process":
            import tempfile
            from pathlib import Path as _Path

            self._proc_scratch = _Path(tempfile.mkdtemp(prefix="fmrp_fleet_proc_"))
        self.state = state
        self.version = 0          # bumped by every committed rollover
        self._registry_dir = registry_dir
        self._service_kwargs = dict(service_kwargs)
        self._max_requeues = int(max_requeues)
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Replica] = {}
        self._graveyard: Dict[str, str] = {}   # rid → why it left
        # dead/retired replicas' lifetime counters fold here so the
        # agg_* roll-up stays MONOTONE across kills and replacements —
        # the ERService retired-executor discipline, one level up (a
        # scraper's rate() over fmrp_fleet_service_agg_n_done must never
        # go negative because a replica died)
        self._agg_prior = {"n_done": 0, "n_rejected": 0, "n_failed": 0,
                           "dispatch_timeouts": 0}
        # fleet-wide metric aggregation (telemetry.distributed): process
        # replicas ship registry deltas on the stats heartbeat, folded
        # under {proc=} labels; thread replicas share this process's
        # registry, so with them it stays empty and its fold is a no-op
        self.aggregator = _obs.MetricAggregator()
        # rid → flight-recorder tail harvested from a process replica's
        # shm annex at its death
        self.flights: Dict[str, dict] = {}
        self._ring = HashRing(vnodes=vnodes)
        self._generation = 0
        self._req_counter = 0
        self._staged_rollover = None
        self._rollover_lock = threading.Lock()
        self.warm_reports: Dict[str, object] = {}  # rid → WarmReport
        # admission
        self.admission = admission or AdmissionPolicy.from_env()
        self._bucket = (
            TokenBucket(self.admission.rate_per_s, self.admission.burst,
                        clock=admission_clock)
            if self.admission.rate_per_s else None
        )
        # outstanding = admitted, not yet terminal (drain() waits on it)
        self._outstanding = 0
        self._outstanding_cv = threading.Condition()
        # journal: a path arms a fleet-owned journal; a RequestJournal
        # instance is caller-owned (left open on close); None = no journal
        # (FMRP_FLEET_JOURNAL provides the default path)
        if journal is None:
            journal = os.environ.get("FMRP_FLEET_JOURNAL") or None
        self._own_journal = not isinstance(journal, RequestJournal)
        self.journal: Optional[RequestJournal] = (
            journal if isinstance(journal, RequestJournal)
            else RequestJournal(journal) if journal else None
        )
        # fleet-level instruments (instance-local values for stats(),
        # aggregated per family for /metrics)
        reg = telemetry.registry()
        self._m_shed = reg.private_counter(
            "fmrp_fleet_shed_requests_total",
            help="requests refused by fleet admission control "
                 "(ServiceOverloadError)",
        )
        self._m_requeues = reg.private_counter(
            "fmrp_fleet_requeues_total",
            help="mid-flight requests requeued off a failed replica",
        )
        self._m_failovers = reg.private_counter(
            "fmrp_fleet_failovers_total",
            help="replicas replaced (drained or dead)",
        )
        self._m_rollovers = reg.private_counter(
            "fmrp_fleet_rollovers_total",
            help="fleet-wide state version rollovers committed",
        )
        self._m_scale_out = reg.private_counter(
            "fmrp_fleet_scale_out_total",
            help="replicas added by the autoscaler (warm-pool spawns)",
        )
        self._m_scale_in = reg.private_counter(
            "fmrp_fleet_scale_in_total",
            help="replicas retired by the autoscaler (drained, not replaced)",
        )
        self._m_degraded = reg.private_counter(
            "fmrp_fleet_degraded_total",
            help="responses served by a disclosed brownout route",
        )
        # brownout ladder: a policy/controller arms it explicitly;
        # FMRP_FLEET_BROWNOUT=1 arms it with the env policy; default off
        # (the submit path then never consults the ladder)
        if brownout is None:
            brownout = os.environ.get("FMRP_FLEET_BROWNOUT", "0") == "1"
        if isinstance(brownout, BrownoutController):
            self.brownout: Optional[BrownoutController] = brownout
        elif isinstance(brownout, BrownoutPolicy):
            self.brownout = BrownoutController(brownout)
        elif brownout:
            self.brownout = BrownoutController()
        else:
            self.brownout = None
        self._crashed = False
        # set by TopologyController.__init__ when one adopts this fleet;
        # the supervisor's scale verbs prefer it over direct fleet calls
        self.topology = None
        try:
            self._add_replicas(n_replicas)
        except Exception:
            # a spawn failure mid-loop must not leak what already started:
            # the started replicas hold graphs and memory on the card
            with self._lock:
                reps = list(self._replicas.values())
            for rep in reps:
                try:
                    rep.service.kill("fleet start aborted")
                    rep.service.release()
                except Exception:  # noqa: BLE001 — best-effort reap
                    pass
            self._cleanup_scratch()
            raise
        self._update_gauges()
        # the journal doubles as the fleet's topology record: size-carrying
        # marks (here, scale_out/scale_in/retire) are what crash-restart
        # recovery reads to respawn the right replica count
        self._jrnl_mark("fleet_start", size=n_replicas,
                        version=self.version)
        # optional background supervision (tests tick manually); the
        # autoscaler leg rides the same tick, its cooldown on the same
        # injectable clock as admission
        self.supervisor = Supervisor(self, policy=health,
                                     autoscale=autoscale,
                                     clock=admission_clock)
        if probe_interval_s is None:
            env = os.environ.get("FMRP_FLEET_PROBE_S")
            probe_interval_s = float(env) if env else None
        if probe_interval_s:
            self.supervisor.start(probe_interval_s)

    # -- replica lifecycle -------------------------------------------------

    def _next_rid(self) -> str:
        with self._lock:
            rid = f"r{self._generation}"
            self._generation += 1
            return rid

    def _spawn_service(self, rid: str, state) -> ERService:
        """One replica's service, warmed. With a registry armed (explicitly
        via ``registry_dir`` or through ``FMRP_REGISTRY_DIR``, resolved
        live per spawn) the warm pool starts it (``WarmReport`` recorded);
        without one it warms in place."""
        kwargs = dict(
            self._service_kwargs,
            metric_labels={"replica": rid},
            replica_id=rid,
        )
        reg_dir = self._registry_dir
        if reg_dir is None:
            from fm_returnprediction_tpu_torch.registry.store import registry_dir

            reg_dir = registry_dir()
        if self.replica_mode == "process":
            # a spawned child: the warm-pool start happens there, and its
            # WarmReport rides back in the hello
            from fm_returnprediction_tpu_torch.serving.replica_proc import ProcessReplica

            service = ProcessReplica(
                rid, state, scratch=self._proc_scratch,
                service_kwargs=self._service_kwargs, registry_dir=reg_dir,
                transport=self._transport,
            )
            # the stats heartbeat doubles as the metric-aggregation wire
            service.metrics_sink = self.aggregator.ingest
            if service.warm_report is not None:
                self.warm_reports[rid] = service.warm_report
            return service
        if reg_dir is not None:
            from fm_returnprediction_tpu_torch.registry.warm import (
                warm_from_registry,
            )

            service, report = warm_from_registry(
                state=state, registry_dir=reg_dir,
                service_cls=_ReplicaService, **kwargs,
            )
            self.warm_reports[rid] = report
            return service
        return _ReplicaService(state, **kwargs)

    def _add_replica(self) -> str:
        rid = self._next_rid()
        service = self._spawn_service(rid, self.state)
        with self._lock:
            self._replicas[rid] = _Replica(rid, service, self._generation)
            self._ring.add(rid)
        self._update_gauges()
        return rid

    def _add_replicas(self, n: int) -> List[str]:
        """The fleet's first ``n`` replicas. Process replicas start
        concurrently: each child's interpreter, torch import, CUDA context
        and warm-up overlap the others' (seconds each on the card), and a
        failed start reaps the ones that did start before it raises."""
        if self.replica_mode != "process" or n < 2:
            return [self._add_replica() for _ in range(n)]
        from concurrent.futures import ThreadPoolExecutor

        from fm_returnprediction_tpu_torch.serving.replica_proc import _ship_state

        _ship_state(self.state, self._proc_scratch)  # one bundle for every child
        rids = [self._next_rid() for _ in range(n)]
        with ThreadPoolExecutor(max_workers=n, thread_name_prefix="fmrp-spawn") as pool:
            # each spawn runs in a copy of this context, so the open span
            # reaches the child as its remote parent (trace_env)
            futs = [pool.submit(contextvars.copy_context().run, self._spawn_service, rid,
                                self.state) for rid in rids]
        started, errors = [], []
        for rid, fut in zip(rids, futs):
            try:
                started.append((rid, fut.result()))
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)
        if errors:
            for _, service in started:
                service.kill("fleet start aborted")
                service.release()
            raise errors[0]
        with self._lock:
            for rid, service in started:
                self._replicas[rid] = _Replica(rid, service, self._generation)
                self._ring.add(rid)
        self._update_gauges()
        return rids

    def _fold_final(self, rep: _Replica) -> None:
        """Fold a departing replica's cumulative counters into the fleet
        prior (once per replica; queue_depth is point-in-time and is
        deliberately NOT folded — a dead replica's queue is gone)."""
        if rep.folded:
            return
        rep.folded = True
        # aggregated series fold the same way (a no-op for thread
        # replicas, which never shipped a delta)
        self.aggregator.fold_dead(rep.rid)
        # post-mortem: the flight tail a process replica mirrored into its
        # shm annex (cached on the handle at death; never raises)
        harvest = getattr(rep.service, "harvest_flight", None)
        if harvest is not None:
            flight = harvest()
            if flight is not None:
                with self._lock:
                    self.flights[rep.rid] = flight
        try:
            s = rep.service.stats()
        except Exception:  # noqa: BLE001 — a corpse that can't report
            return         # loses its tail counts, disclosed by graveyard
        with self._lock:
            for k in self._agg_prior:
                self._agg_prior[k] += int(s.get(k) or 0)

    def replica(self, rid: str) -> Optional[_Replica]:
        with self._lock:
            return self._replicas.get(rid)

    def replica_states(self) -> Dict[str, str]:
        with self._lock:
            return {rid: rep.state for rid, rep in self._replicas.items()}

    def replica_idle(self, rid: str) -> bool:
        """Nothing queued and nothing in flight — safe to retire."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return True
            return rep.inflight == 0 and rep.service.batcher.queue_depth == 0

    def decommission(self, rid: str, reasons: Sequence[str] = ()) -> None:
        """Mark a replica DRAINING: the router excludes it immediately,
        but it keeps answering what it already holds (the supervisor
        retires it once idle)."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != HEALTHY:
                return
            rep.state = DRAINING
            rep.reasons = list(reasons)
        self._jrnl_mark("drain", replica=rid, reasons=";".join(reasons))
        telemetry.event("fleet.drain", cat="fleet", replica=rid,
                        reasons=";".join(reasons))
        self._update_gauges()

    def kill_replica(self, rid: str, reason: str = "killed") -> int:
        """Abrupt replica death (chaos/force-kill path): queued requests
        fail with ``ReplicaDeadError`` and the fleet requeues them on
        healthy replicas. Returns how many were stranded-and-requeued."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state == DEAD:
                return 0
            rep.state = DEAD
            rep.reasons.append(reason)
            self._ring.remove(rid)
        self._jrnl_mark("replica_kill", replica=rid, reason=reason)
        telemetry.event("fleet.replica_kill", cat="fleet", replica=rid,
                        reason=reason)
        # outside the lock: failing the queue fires done-callbacks that
        # re-enter the fleet to requeue
        stranded = rep.service.kill(reason)
        self._fold_final(rep)
        # a dead replica's graphs and device memory go now, not when the
        # supervisor replaces it
        rep.service.release()
        self._update_gauges()
        return stranded

    def replace(self, rid: str, reason: str = "replaced") -> str:
        """Retire a DEAD/idle-DRAINING replica and spawn its replacement
        from the CURRENT state version (warm pool when armed). The
        supervisor's failover verb.

        Serialized against :meth:`rollover` (the rollover lock): a
        replacement spawned while a rollover is mid-PREPARE would read
        the old ``self.state``, miss the commit loop's flip (it is not
        in the prepare snapshot), and leave the fleet split across
        versions — exactly what the two-phase protocol promises cannot
        happen. Failover therefore waits out an in-flight rollover (and
        vice versa); both are control-plane rare."""
        with self._rollover_lock:
            with self._lock:
                rep = self._replicas.pop(rid, None)
                if rep is not None:
                    self._ring.remove(rid)
                    self._graveyard[rid] = reason
            if rep is not None and rep.state != DEAD:
                rep.service.close()     # graceful: drains what's left
            if rep is not None:
                self._fold_final(rep)   # no-op for already-folded kills
                rep.service.release()   # idempotent after a kill
            new_rid = self._add_replica()
        self._m_failovers.inc()
        self._jrnl_mark("failover", replica=rid, replacement=new_rid,
                        reason=reason)
        telemetry.event("fleet.failover", cat="fleet", replica=rid,
                        replacement=new_rid, reason=reason)
        self._update_gauges()
        return new_rid

    # -- elasticity (the autoscaler's verbs) --------------------------------

    def scale_out(self, n: int = 1, reason: str = "pressure") -> List[str]:
        """Add ``n`` replicas at the CURRENT state version — build-free
        when a registry is armed (the same warm pool failover uses).
        Serialized against :meth:`rollover` for the same reason
        :meth:`replace` is: a replica spawned mid-PREPARE would miss the
        commit flip and split the fleet across versions."""
        rids: List[str] = []
        with self._rollover_lock:
            for _ in range(max(int(n), 0)):
                rids.append(self._add_replica())
        if not rids:
            return rids
        self._m_scale_out.inc(len(rids))
        with self._lock:
            size = len(self._replicas)
        self._jrnl_mark("scale_out", replicas=",".join(rids), size=size,
                        reason=reason)
        telemetry.event("fleet.scale_out", cat="fleet",
                        replicas=",".join(rids), reason=reason)
        self._update_gauges()
        return rids

    def scale_in(self, reason: str = "relief") -> Optional[str]:
        """Retire ONE replica: the youngest healthy replica drains through
        the existing DRAINING machinery (router excludes it immediately,
        queued work completes) and the supervisor RETIRES it once idle —
        no replacement spawned. Returns the draining rid, or None when
        the fleet is already minimal."""
        with self._rollover_lock:
            with self._lock:
                healthy = [
                    rep for rep in self._replicas.values()
                    if rep.state == HEALTHY
                ]
                if len(healthy) <= 1:
                    return None
                rep = max(healthy, key=lambda r: r.generation)
                rep.retire_on_drain = True
            self.decommission(rep.rid, reasons=[f"scale-in: {reason}"])
        self._m_scale_in.inc()
        with self._lock:
            # the post-retire size this drain is headed for (the live
            # count still includes the draining replica)
            size = len(self._replicas) - 1
        self._jrnl_mark("scale_in", replica=rep.rid, size=size,
                        reason=reason)
        telemetry.event("fleet.scale_in", cat="fleet", replica=rep.rid,
                        reason=reason)
        return rep.rid

    def retire(self, rid: str, reason: str = "scaled in") -> None:
        """Remove a replica WITHOUT spawning a replacement (the scale-in
        terminal; contrast :meth:`replace`). Serialized on the rollover
        lock like every topology mutation."""
        with self._rollover_lock:
            with self._lock:
                rep = self._replicas.pop(rid, None)
                if rep is not None:
                    self._ring.remove(rid)
                    self._graveyard[rid] = reason
            if rep is None:
                return
            if rep.state != DEAD:
                rep.service.close()
            self._fold_final(rep)
            rep.service.release()
        with self._lock:
            size = len(self._replicas)
        self._jrnl_mark("retire", replica=rid, size=size, reason=reason)
        telemetry.event("fleet.retire", cat="fleet", replica=rid,
                        reason=reason)
        self._update_gauges()

    @property
    def shed_total(self) -> int:
        """Lifetime admission sheds (the supervisor's delta signal)."""
        return self._m_shed.value

    def _note_brownout(self, step: Optional[str], ctl) -> None:
        """Journal/export a brownout ladder transition (supervisor tick
        callback); the level gauge refreshes every tick either way."""
        telemetry.registry().gauge(
            "fmrp_fleet_brownout_level",
            help="degradation ladder position: 0 full service",
        ).set(ctl.level)
        if step is None:
            return
        rung = ctl.active_rung() or "full"
        self._jrnl_mark("brownout", step=step, rung=rung, level=ctl.level)
        telemetry.event("fleet.brownout", cat="fleet", step=step,
                        rung=rung, level=ctl.level)

    # -- admission ---------------------------------------------------------

    def _queue_snapshot(self) -> Tuple[int, int, int]:
        """(aggregate queue depth, aggregate ceiling, healthy count) over
        replicas the router would consider."""
        depth = ceiling = healthy = 0
        with self._lock:
            for rep in self._replicas.values():
                if rep.state == HEALTHY:
                    healthy += 1
                    depth += rep.service.batcher.queue_depth
                    ceiling += rep.service.batcher.max_queue
        return depth, ceiling, healthy

    def _shed(self, req: Optional[int], message: str, *, reason: str,
              retry_after_s: float, queue_depth=None, queue_ceiling=None):
        self._m_shed.inc()
        self._jrnl("shed", req, reason=reason)
        telemetry.event("fleet.shed", cat="fleet", reason=reason)
        raise ServiceOverloadError(
            message,
            retry_after_s=max(retry_after_s,
                              self.admission.retry_after_floor_s),
            reason=reason, queue_depth=queue_depth,
            queue_ceiling=queue_ceiling,
        )

    def _drain_hint_s(self, excess_rows: int, healthy: int) -> float:
        """How long until the queues drain ``excess_rows``: each healthy
        replica retires up to ``max_batch`` rows per ``max_latency``
        flush window."""
        max_batch = int(self._service_kwargs.get("max_batch", 256))
        max_latency_s = (
            float(self._service_kwargs.get("max_latency_ms", 2.0)) / 1e3
        )
        batches = math.ceil(excess_rows / max(1, healthy * max_batch))
        return batches * max_latency_s

    def _admit(self, req: int, degraded: bool = False) -> None:
        """The front door: token bucket, then queue occupancy. Raises
        :class:`ServiceOverloadError` (journaled ``shed``) on refusal.

        ``degraded`` (a brownout rung below full is active): the
        queue-derived checks — occupancy and healthy-replica count — are
        SKIPPED, because a degraded request never touches a queue or a
        replica (host-side answer). Occupancy shedding at the default
        0.9 would otherwise preempt the ladder exactly when the queues
        are pinned at ceiling — the scenario the ladder exists for. The
        token bucket still applies: it is a rate POLICY, not congestion
        protection."""
        if self._bucket is not None:
            wait = self._bucket.try_acquire()
            if wait is not None:
                self._shed(
                    req, f"admission rate limit; retry in {wait:.3f}s",
                    reason="token_bucket", retry_after_s=wait,
                )
        if degraded:
            return
        depth, ceiling, healthy = self._queue_snapshot()
        if healthy == 0:
            self._shed(
                req, "no healthy replicas (failover in progress)",
                reason="no_healthy_replicas",
                retry_after_s=self.admission.retry_after_floor_s * 10,
            )
        if ceiling and depth >= self.admission.max_occupancy * ceiling:
            excess = depth - int(self.admission.max_occupancy * ceiling) + 1
            self._shed(
                req,
                f"fleet queues at {depth}/{ceiling} "
                f"(≥ {self.admission.max_occupancy:.0%} occupancy)",
                reason="queue_occupancy",
                retry_after_s=self._drain_hint_s(excess, healthy),
                queue_depth=depth, queue_ceiling=ceiling,
            )

    # -- journal helpers ---------------------------------------------------

    def _jrnl(self, ev: str, req: Optional[int], **fields) -> None:
        if self.journal is not None:
            self.journal.append(ev, req, **fields)

    def _jrnl_mark(self, label: str, **fields) -> None:
        if self.journal is not None:
            self.journal.mark(label, **fields)

    # -- the submit path ---------------------------------------------------

    def submit(self, month, x, key: Optional[str] = None) -> Future:
        """Admission-controlled async query; returns the fleet-level
        Future. Raises :class:`ServiceOverloadError` when shed (429 —
        retriable after ``retry_after_s``), ``KeyError`` for a month no
        state version knows. ``key`` opts into affinity routing (same key
        → same replica while membership holds); default is per-request
        spread."""
        # request-timeline origin: hop.admit runs entry → handed to the
        # routing layer; t0 also anchors the fleet.request e2e span the
        # terminal callback closes (zero = unarmed, every stamp no-ops)
        t0 = time.perf_counter_ns() if _spans.active() else 0
        with self._lock:
            self._req_counter += 1
            req = self._req_counter
        # ONE rung read for the whole request: admission and the serve
        # path below must agree on whether this request is degraded
        ctl = self.brownout
        rung = ctl.active_rung() if ctl is not None else None
        # ANY active rung bypasses the queue-derived admission checks:
        # degraded rungs never touch a queue, and on the shed rung the
        # refusal must be the ladder's own typed brownout_shed (reason +
        # shed_retry_after_s) — not an occupancy shed that happens to
        # fire first and mislabels the episode
        self._admit(req, degraded=rung is not None)  # may raise
        #                                             (journals shed)
        self._jrnl("admit", req)
        with self._outstanding_cv:
            self._outstanding += 1
        outer: Future = Future()
        try:
            # chaos: a staged rollover can be triggered HERE,
            # deterministically mid-load (fleet.swap_mid_flight +
            # stage_rollover), and fleet.hard_crash can abandon the whole
            # fleet between two specific admits (the crash-restart
            # recovery path under test); inside the try — the admit above
            # must reach a terminal even when the site (or what it
            # triggers) raises
            fault_site("fleet.swap_mid_flight", payload=self)
            fault_site("fleet.hard_crash", payload=self)
            if rung is not None:
                if rung == _brownout.RUNG_SHED:
                    # the ladder's last rung IS the old behavior: a typed
                    # retriable 429 (journaled as a shed terminal by the
                    # except below)
                    raise ServiceOverloadError(
                        "brownout ladder at shed (degraded routes "
                        "exhausted); retry after recovery",
                        retry_after_s=ctl.policy.shed_retry_after_s,
                        reason="brownout_shed",
                    )
                self._serve_degraded(req, month, x, rung, outer)
                if t0:
                    _spans.record_span("fleet.request", t0, cat="request",
                                       req=req, route=rung)
                return outer
            if t0:
                _spans.record_span("hop.admit", t0, req=req)
            self._route_and_submit(req, month, x, key or str(req), outer,
                                   tried=frozenset(), attempt=0, t0=t0)
        except Exception as exc:
            # admitted but terminal at submit time — unroutable (all
            # queues refused), malformed, or an exception out of a chaos
            # site / a chaos-triggered rollover. Catching EVERYTHING here
            # is the accounting invariant: the admit was journaled and
            # ``_outstanding`` incremented above, so any escape without a
            # terminal event would strand drain()/close() and replay as a
            # dropped request. (Once a request is in flight, terminal
            # ownership moves to the done-callback — _route_and_submit
            # never raises past that point.)
            ev = "shed" if isinstance(exc, ServiceOverloadError) else "error"
            self._jrnl(ev, req, reason=getattr(exc, "reason", None),
                       error=None if ev == "shed" else repr(exc)[:200])
            if isinstance(exc, ServiceOverloadError):
                self._m_shed.inc()
            self._finish()
            raise
        return outer

    def _route_and_submit(self, req: int, month, x, key: str,
                          outer: Future, tried: frozenset,
                          attempt: int, t0: int = 0) -> None:
        tried = set(tried)
        while True:
            with self._lock:
                unfit = {
                    rid for rid, rep in self._replicas.items()
                    if rep.state != HEALTHY
                }
            rid = self._ring.route(key, exclude=tried | unfit)
            if rid is None:
                depth, ceiling, healthy = self._queue_snapshot()
                raise ServiceOverloadError(
                    "every healthy replica refused the request "
                    f"(queues {depth}/{ceiling})",
                    reason=("replica_backpressure" if healthy
                            else "no_healthy_replicas"),
                    retry_after_s=max(
                        self._drain_hint_s(max(depth - ceiling + 1, 1),
                                           max(healthy, 1)),
                        self.admission.retry_after_floor_s,
                    ),
                    queue_depth=depth, queue_ceiling=ceiling,
                )
            rep = self.replica(rid)
            if rep is None:
                tried.add(rid)
                continue
            self._jrnl("route", req, replica=rid)
            try:
                inner = rep.service.submit(month, x)
            except QueueFullError:
                self._jrnl("requeue", req, replica=rid,
                           reason="backpressure")
                tried.add(rid)
                continue
            except RuntimeError:
                # "batcher is closed" — the replica died between the
                # routing decision and the enqueue; pick another
                self._jrnl("requeue", req, replica=rid,
                           reason="replica_closed")
                tried.add(rid)
                continue
            break
        with self._lock:
            rep.inflight += 1
        inner.add_done_callback(
            lambda fut: self._on_inner_done(req, month, x, key, outer,
                                            rid, tried, attempt, fut, t0)
        )
        # chaos: kill the replica this request is now IN FLIGHT on — the
        # callback's requeue path is what makes that survivable. The site
        # fires AFTER callback registration (terminal ownership has moved
        # to the callback), so a raising spec here must be swallowed:
        # letting it escape would double-resolve the request. Kills are
        # injected via mutate=fleet_kill_routed, not exc=.
        try:
            fault_site("fleet.replica_kill", payload=(self, rid))
        except Exception:  # noqa: BLE001 — see above
            pass

    def _serve_degraded(self, req: int, month, x, rung: str,
                        outer: Future) -> None:
        """One brownout response: answered HOST-SIDE from the frozen state
        (``serving.brownout``), bypassing the saturated batcher/executor
        path — the congested resource gets zero new work, which is what
        lets the burn recover. Journaled as route→done against the
        synthetic replica ``brownout:<rung>`` so replay stays clean and a
        reader can see which requests the ladder answered. Exceptions
        (unknown month, a poisoned row) propagate to submit's accounting
        except-clause exactly like the full path's synchronous failures."""
        self._jrnl("route", req, replica=f"brownout:{rung}")
        # ONE state read: a rollover committing between "resolve the
        # index" and "read the arrays" would pair the new vocabulary
        # with the old coefficients (wrong-month quote, or IndexError
        # on a freshly appended month)
        st = self.state
        quote = self.brownout.answer(st, st.month_index(month), x, rung)
        self._jrnl("done", req, route=rung)
        self._m_degraded.inc()
        telemetry.event("fleet.degraded", cat="fleet", route=rung)
        self._finish()
        if not outer.cancelled():
            outer.set_result(quote)

    def _on_inner_done(self, req: int, month, x, key: str, outer: Future,
                       rid: str, tried: set, attempt: int, inner: Future,
                       t0: int = 0) -> None:
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is not None and rep.inflight > 0:
                rep.inflight -= 1
        exc = inner.exception()
        if exc is None:
            self._jrnl("done", req)
            if t0:
                # the e2e request span the per-hop table divides into
                _spans.record_span("fleet.request", t0, cat="request",
                                   req=req, replica=rid)
            self._finish()
            if not outer.cancelled():
                outer.set_result(inner.result())
            return
        if isinstance(exc, _REQUEUEABLE) and attempt < self._max_requeues:
            self._jrnl("requeue", req, replica=rid,
                       reason=type(exc).__name__)
            self._m_requeues.inc()
            telemetry.event("fleet.requeue", cat="fleet", replica=rid,
                            reason=type(exc).__name__)
            try:
                self._route_and_submit(req, month, x, key, outer,
                                       tried=frozenset(tried | {rid}),
                                       attempt=attempt + 1, t0=t0)
                return
            except Exception as requeue_exc:  # noqa: BLE001 — delivered
                exc = requeue_exc
        self._jrnl("error", req, error=repr(exc)[:200])
        if t0:
            _spans.record_span("fleet.request", t0, cat="request", req=req,
                               replica=rid, error=type(exc).__name__)
        self._finish()
        if not outer.cancelled():
            outer.set_exception(exc)

    def _finish(self) -> None:
        with self._outstanding_cv:
            self._outstanding -= 1
            self._outstanding_cv.notify_all()

    def query(self, month, x, timeout: Optional[float] = 30.0) -> float:
        """Blocking single query → E[r] (see ``ERService.query``)."""
        return self.submit(month, x).result(timeout=timeout)

    def query_many(self, months: Sequence, xs,
                   timeout: Optional[float] = 30.0) -> np.ndarray:
        futures = [self.submit(m, x) for m, x in zip(months, xs)]
        return np.asarray([f.result(timeout=timeout) for f in futures])

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Wait until every admitted request has reached its terminal
        journal event; True when fully drained."""
        with self._outstanding_cv:
            self._outstanding_cv.wait_for(
                lambda: self._outstanding == 0, timeout
            )
            return self._outstanding == 0

    def flush_all(self) -> int:
        """Synchronously pump every replica's batcher dry (deterministic
        tests run with ``auto_flush=False``)."""
        total = 0
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.state != DEAD:
                total += rep.service.batcher.drain()
        return total

    # -- zero-downtime versioned rollover ----------------------------------

    @staticmethod
    def _validate_candidate(old, new) -> None:
        """Reject a rollover candidate that could not serve: the fleet
        flips nothing unless the new version is a superset of the old
        vocabulary with at least one quotable month and finite support
        bounds. (The last fence before PREPARE; the chaos
        ``fleet.poison_state`` site injects exactly what this catches.)"""
        if new is old:
            raise IngestRejectedError("rollover to the identical state")
        if new.n_predictors != old.n_predictors:
            raise IngestRejectedError(
                f"predictor width changed {old.n_predictors}→"
                f"{new.n_predictors}; a rollover cannot re-featurize"
            )
        if new.n_months < old.n_months:
            raise IngestRejectedError(
                f"version chain moved backwards ({old.n_months}→"
                f"{new.n_months} months)"
            )
        if not np.array_equal(new.months[: old.n_months], old.months):
            raise IngestRejectedError(
                "month vocabulary is not an append-only extension"
            )
        if not new.have_coef().any():
            raise IngestRejectedError(
                "candidate has no quotable months (poisoned coefficients?)"
            )
        if np.isnan(new.x_lo).any() or np.isnan(new.x_hi).any():
            raise IngestRejectedError("candidate support bounds carry NaN")

    def rollover(self, new_state) -> int:
        """Fleet-wide zero-downtime state rollover; returns the new
        version number.

        Two-phase: PREPARE validates the candidate and builds+warms its
        executor on EVERY replica (queries keep flowing on the old
        version throughout); only if all replicas prepared does COMMIT
        flip each one atomically. A failure anywhere in prepare raises
        :class:`StateRolloverError` with ZERO flips — the fleet can never
        end up split across versions. In-flight requests finish on
        whichever executor they started with (append-only month slots),
        which the journal replay proves: zero dropped, zero duplicated
        across the swap window."""
        with self._rollover_lock:
            old = self.state
            self._jrnl_mark("rollover_begin", version=self.version + 1,
                            n_months=int(new_state.n_months))
            with self._lock:
                snapshot = [
                    (rid, rep) for rid, rep in self._replicas.items()
                    if rep.state in (HEALTHY, DRAINING)
                ]
            prepared = {}
            # prepare under the fleet's registry (pass-through when
            # unarmed): the FIRST replica's warm-up stores the new
            # version's bucket programs, later replicas — and every
            # post-rollover failover replacement — fetch them, so a
            # rollover never un-warms the warm pool
            from fm_returnprediction_tpu_torch.registry.store import using_registry

            with using_registry(self._registry_dir):
                for rid, rep in snapshot:
                    try:
                        candidate = fault_site("fleet.poison_state",
                                               payload=new_state)
                        self._validate_candidate(old, candidate)
                        with telemetry.span("fleet.prepare", cat="fleet",
                                            replica=rid):
                            prepared[rid] = rep.service.prepare_state(
                                candidate
                            )
                    except Exception as exc:  # noqa: BLE001 — abort, no flips
                        self._jrnl_mark("rollover_abort", replica=rid,
                                        error=repr(exc)[:200])
                        telemetry.event("fleet.rollover_abort", cat="fleet",
                                        replica=rid, error=repr(exc)[:200])
                        raise StateRolloverError(
                            f"rollover aborted preparing {rid}: {exc!r} "
                            "(no replica flipped; fleet still serving "
                            f"version {self.version})"
                        ) from exc
            for rid, rep in snapshot:
                rep.service.commit_state(prepared[rid])
            self.state = new_state
            self.version += 1
            self._m_rollovers.inc()
            self._jrnl_mark("rollover_commit", version=self.version)
            telemetry.event("fleet.rollover", cat="fleet",
                            version=self.version)
            return self.version

    def stage_rollover(self, new_state) -> None:
        """Park a candidate version for the ``fleet.swap_mid_flight``
        chaos site (or a later explicit :meth:`trigger_staged_rollover`)
        to fire DURING load — how the swap-under-load tests make the
        swap window land deterministically between two specific
        requests."""
        self._staged_rollover = new_state

    def trigger_staged_rollover(self) -> bool:
        staged, self._staged_rollover = self._staged_rollover, None
        if staged is None:
            return False
        self.rollover(staged)
        return True

    # -- instrumentation ---------------------------------------------------

    def _update_gauges(self) -> None:
        reg = telemetry.registry()
        states = self.replica_states()
        healthy = sum(1 for s in states.values() if s == HEALTHY)
        reg.gauge(
            "fmrp_fleet_healthy_replicas",
            help="replicas currently accepting routed traffic",
        ).set(healthy)
        reg.gauge(
            "fmrp_fleet_size",
            help="live replicas (healthy + draining + dead-not-replaced)",
        ).set(len(states))

    def stats(self) -> dict:
        """Fleet roll-up: aggregate queue/latency counters, per-replica
        detail, admission/failover totals, version."""
        with self._lock:
            reps = dict(self._replicas)
            agg = {"queue_depth": 0, **self._agg_prior}
        per_replica = {}
        for rid, rep in reps.items():
            if rep.state == DEAD:
                per_replica[rid] = {"state": DEAD,
                                    "reasons": list(rep.reasons)}
                continue
            s = rep.service.stats()
            per_replica[rid] = {
                "state": rep.state,
                "inflight": rep.inflight,
                "queue_depth": s["queue_depth"],
                "n_done": s["n_done"],
                "p99_ms": s["p99_ms"],
                "degraded": s["degraded"],
                "dispatch_timeouts": s["dispatch_timeouts"],
                "slo_state": s.get("slo_state"),
                "transport": s.get("transport"),
                "reasons": list(rep.reasons),
            }
            for k in ("n_done", "n_rejected", "n_failed", "queue_depth",
                      "dispatch_timeouts"):
                agg[k] += int(s[k] or 0)
        states = {rid: d["state"] for rid, d in per_replica.items()}
        # fleet SLO roll-up: the WORST armed replica objective (the
        # supervisor drains breaching replicas; this is the remaining
        # fleet-wide signal an alert keys off)
        slo_order = {None: -1, "ok": 0, "warn": 1, "breach": 2}
        slo_states = [
            d.get("slo_state") for d in per_replica.values()
            if d.get("slo_state") is not None
        ]
        worst_slo = (
            max(slo_states, key=lambda s: slo_order.get(s, 0))
            if slo_states else None
        )
        transports = {d.get("transport") for d in per_replica.values()
                      if d.get("transport")}
        return {
            "fleet_size": len(reps),
            "replica_mode": self.replica_mode,
            "transport": (sorted(transports)[0] if len(transports) == 1
                          else sorted(transports) or None),
            "slo_state": worst_slo,
            "brownout_level": (
                self.brownout.level if self.brownout is not None else None
            ),
            "brownout_rung": (
                self.brownout.active_rung() or "full"
                if self.brownout is not None else None
            ),
            "degraded_total": self._m_degraded.value,
            "scale_out_total": self._m_scale_out.value,
            "scale_in_total": self._m_scale_in.value,
            "healthy_replicas": sum(
                1 for s in states.values() if s == HEALTHY
            ),
            "draining_replicas": sorted(
                r for r, s in states.items() if s == DRAINING
            ),
            "dead_replicas": sorted(
                r for r, s in states.items() if s == DEAD
            ),
            "version": self.version,
            "outstanding": self._outstanding,
            "shed_total": self._m_shed.value,
            "requeues_total": self._m_requeues.value,
            "failovers_total": self._m_failovers.value,
            "rollovers_total": self._m_rollovers.value,
            "replaced": dict(self._graveyard),
            **{f"agg_{k}": v for k, v in agg.items()},
            "replicas": per_replica,
        }

    def prometheus_metrics(self) -> str:
        """Process registry (per-replica ``fmrp_*{replica=}`` families +
        fleet gauges) plus the fleet's numeric roll-up as
        ``fmrp_fleet_service_*`` gauges, in text exposition format (label
        values are escaped by the exporter, not trusted here)."""
        self._update_gauges()
        flat = {
            k: v for k, v in self.stats().items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        from fm_returnprediction_tpu_torch.telemetry import metrics as _metrics

        # ONE snapshot-lock hold across the registry render AND the
        # aggregated child fold: a kill_replica folding mid-scrape can
        # no longer tear the exposition (live series gone, departed fold
        # not yet rendered → fleet totals dip then recover)
        with _metrics.SNAPSHOT_LOCK:
            text = telemetry.prometheus_text(
                extra=flat, extra_prefix="fmrp_fleet_service_"
            )
            return text + self.aggregator.prometheus_text()

    def start_metrics_server(self, port: int = 0, host: str = "127.0.0.1"):
        """Serve :meth:`prometheus_metrics` over HTTP (``GET /metrics``);
        same contract as ``ERService.start_metrics_server`` (and the same
        ``telemetry.export.serve_metrics_http`` implementation)."""
        from fm_returnprediction_tpu_torch.telemetry.export import (
            serve_metrics_http,
        )

        if getattr(self, "_metrics_server", None) is not None:
            raise RuntimeError(
                "metrics server already running; close() the fleet first "
                "(a second bind would orphan the first server's daemon "
                "thread and socket)"
            )
        self._metrics_server = serve_metrics_http(
            self.prometheus_metrics, port=port, host=host,
            name="fmrp-fleet-metrics",
        )
        return self._metrics_server.server_address

    # -- crash-restart recovery --------------------------------------------

    def hard_crash(self) -> None:
        """Simulate abrupt PROCESS DEATH (the chaos verb behind the
        ``fleet.hard_crash`` site): supervision stops, the journal's file
        handle drops with NO terminal events and NO rotation — optionally
        torn mid-line by the ``fleet.journal_torn_tail`` site — and every
        replica is killed with journaling already dead (a real corpse
        writes nothing). The object is garbage afterwards; the journal
        file on disk is exactly what a crashed process leaves behind, and
        :meth:`recover` is how the next fleet picks it up.

        The corpse shares the card with the fleet that recovers it, so
        every replica is also FENCED: a thread replica's flusher is joined
        (a batch mid-dispatch finishes), its executors' streams are
        synchronized and their graphs and device memory freed
        (``ERService.release``); a process replica's child is killed and
        reaped. After this returns, nothing of the crashed fleet runs on
        the card."""
        self._crashed = True
        self.supervisor.stop()
        telemetry.event("fleet.hard_crash", cat="fleet")
        j = self.journal
        if j is not None:
            j.abandon()   # abrupt: no close-out, no rotation
            # chaos: tear the final line the way a crash mid-append does
            fault_site("fleet.journal_torn_tail", path=j.path)
        server = getattr(self, "_metrics_server", None)
        if server is not None:
            server.shutdown()
            server.server_close()
            self._metrics_server = None
        with self._lock:
            reps = list(self._replicas.values())
        # kill AFTER the journal is dead: the done-callbacks these fire
        # (requeue attempts, terminal accounting) write nothing — the
        # in-flight requests stay journal-dangling, exactly like a crash
        for rep in reps:
            if rep.state != DEAD:
                rep.state = DEAD
                try:
                    rep.service.kill("hard crash")
                except Exception:  # noqa: BLE001 — a corpse is a corpse
                    pass
        for rep in reps:
            rep.service.release()   # the fence: see the docstring
        self._cleanup_scratch()

    def _cleanup_scratch(self) -> None:
        """Remove the process replicas' scratch tree (state bundles, spawn
        configs, child logs); nothing in thread mode."""
        if self._proc_scratch is not None:
            from fm_returnprediction_tpu_torch.serving.replica_proc import cleanup_scratch

            cleanup_scratch(self._proc_scratch)

    @classmethod
    def recover(cls, journal, registry_dir=None, state=None,
                n_replicas: Optional[int] = None, **fleet_kwargs):
        """Rebuild a fleet after a process death: repair + close out the
        crashed session's journal (``serving.recovery`` — every in-flight
        request resolves to a typed retriable outcome and the session
        replays CLEAN), resolve the state from the registry's artifact
        plane (or ``state``), size the fleet from the journal's own
        topology marks (``n_replicas`` overrides), and start every
        replica through the warm pool (no build). Returns
        ``(fleet, RecoveryReport)``.

        The new fleet journals onto the SAME path; the recovered session
        rotates like any other, so the exactly-once evidence chain stays
        one directory of standalone-replayable files."""
        from pathlib import Path

        from fm_returnprediction_tpu_torch.serving.recovery import (
            RecoveryReport,
            recover_journal,
        )

        path = Path(journal)
        jrec = recover_journal(path)
        if n_replicas is None:
            n_replicas = jrec.last_size
        state_source = "explicit"
        if state is None:
            from fm_returnprediction_tpu_torch.registry import artifacts
            from fm_returnprediction_tpu_torch.registry.store import (
                registry_dir as _env_registry_dir,
                using_registry,
            )

            reg_dir = registry_dir
            if reg_dir is None:
                reg_dir = _env_registry_dir()
            if reg_dir is None:
                raise ValueError(
                    "ServingFleet.recover needs a state, a registry_dir, "
                    "or FMRP_REGISTRY_DIR set — a crashed process's state "
                    "lives in the artifact plane"
                )
            with using_registry(reg_dir) as reg:
                state = artifacts.load_serving_state(None, registry=reg)
            if state is None:
                raise FileNotFoundError(
                    f"no serving_state artifact in registry {reg_dir}"
                )
            state_source = f"registry:{reg_dir}"
        fleet = cls(state, n_replicas, registry_dir=registry_dir,
                    journal=path, **fleet_kwargs)
        fleet._jrnl_mark("recovered_from", session=str(
            fleet.journal.rotated_to.name if fleet.journal is not None
            and fleet.journal.rotated_to is not None else ""
        ), closed_out=len(jrec.recovered))
        # names only — re-replaying every retained historical session
        # here would put O(retained history) of JSON parsing on the
        # restart critical path for a cosmetic verdict; the recovered
        # session's own verdict is jrec.replay_clean (rotation is a
        # rename, the bytes are identical), and older sessions were
        # verified when they were live
        sessions = []
        if fleet.journal is not None:
            sessions = [p.name for _, p in fleet.journal.sessions()]
        report = RecoveryReport(
            journal=jrec,
            state_source=state_source,
            n_replicas=len(fleet.replica_states()),
            zero_compile_starts=sum(
                1 for r in fleet.warm_reports.values()
                if getattr(r, "zero_compile", False)
            ),
            rotated_to=(fleet.journal.rotated_to
                        if fleet.journal is not None else None),
            prior_sessions=tuple(sessions),
        )
        telemetry.event("fleet.recovered", cat="fleet",
                        closed_out=len(jrec.recovered),
                        replicas=report.n_replicas)
        return fleet, report

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float = 30.0) -> None:
        """Drain outstanding requests, stop supervision, close every
        replica, release the journal (when fleet-owned)."""
        if self._crashed:
            return  # a hard-crashed fleet is a corpse; nothing to drain
        self.drain(timeout)
        self.supervisor.stop()
        server = getattr(self, "_metrics_server", None)
        if server is not None:
            server.shutdown()
            server.server_close()
            self._metrics_server = None
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.state != DEAD:
                rep.service.close()
            rep.service.release()
        if self.journal is not None and self._own_journal:
            self.journal.close()
        self._cleanup_scratch()

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- CLI smoke ---------------------------------------------------------------


def fleet_smoke(state, fleet_size: int, n_queries: int = 256,
                registry_dir=None, journal_path=None, **fleet_kwargs
                ) -> dict:
    """Stand a fleet up on a fitted state and push a deterministic query
    stream through it — the ``--fleet-size`` CLI path. Queries synthesize
    in-support feature rows for quotable months, so the smoke needs
    nothing beyond the state itself. Returns the fleet roll-up plus the
    journal replay verdict (when journaled)."""
    from pathlib import Path

    from fm_returnprediction_tpu_torch.serving.state import ServingState

    if isinstance(state, (str, Path)):
        state = ServingState.load(state)
    rng = np.random.default_rng(0)
    have = np.nonzero(state.have_coef())[0]
    if not len(have):
        # a short-history state (fewer months than the rolling window's
        # min_periods) has nothing quotable: disclosed, not fatal
        return {"skipped": "state has no quotable months "
                           f"(n_months={state.n_months}, "
                           f"min_periods={state.min_periods})"}
    months = have[rng.integers(0, len(have), n_queries)]
    lo = np.where(np.isfinite(state.x_lo), state.x_lo, -1.0)
    hi = np.where(np.isfinite(state.x_hi), state.x_hi, 1.0)
    t0 = time.perf_counter()
    with ServingFleet(state, fleet_size, registry_dir=registry_dir,
                      journal=journal_path, **fleet_kwargs) as fleet:
        xs = lo[months] + rng.random((n_queries, state.n_predictors)) * (
            hi[months] - lo[months]
        )
        out = fleet.query_many(months.tolist(), xs)
        fleet.drain()
        stats = fleet.stats()
    wall = time.perf_counter() - t0
    result = {
        "fleet_size": fleet_size,
        "n_queries": n_queries,
        "finite_quotes": int(np.isfinite(out).sum()),
        "wall_s": round(wall, 4),
        "rows_per_s": round(n_queries / wall, 1),
        "healthy_replicas": stats["healthy_replicas"],
        "agg_n_done": stats["agg_n_done"],
        "shed_total": stats["shed_total"],
    }
    if journal_path is not None:
        replay = replay_journal(journal_path)
        result["journal"] = {
            "admitted": replay.n_admitted,
            "done": replay.n_done,
            "dropped": len(replay.dropped),
            "duplicated": len(replay.duplicated),
            "clean": replay.clean,
        }
    return result
