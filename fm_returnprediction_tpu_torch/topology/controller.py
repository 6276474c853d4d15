"""One topology controller: the supervised inventory behind one pane.

The serving fleet supervises replicas; the grid pool supervises its
workers and broker; this module treats ALL of them — router, thread
replicas, process replicas (shm|socket), grid workers, the exchange
broker — as ONE declared inventory (:class:`TopologySpec`) with one
liveness ladder, one set of repair verbs, and one journal record that
crash-restart recovery can rebuild ANY shape from.

Liveness ladder (process replicas; each probe classifies DISTINCTLY):

1. ``killed`` — the OS pid is gone (``Popen.poll()`` non-None). A
   SIGKILL'd child.
2. ``ring_stalled`` — pid alive, but the shm request ring shows a
   committed-vs-consumed backlog that did not drain between two probe
   samples (``ShmRing.watermark()``). The data plane is wedged even if
   the pid looks healthy.
3. ``hung`` — pid alive, ring clean, but the control-plane ping did not
   answer inside ``FMRP_TOPO_PING_TIMEOUT_S``. A process that exists
   but no longer serves verbs.

Repair verbs reuse the machinery that already exists rather than
inventing a second lifecycle: a dead/hung/ring-stalled replica is
killed (which tears down and unlinks its shm rings + doorbells) and
replaced through ``ServingFleet.replace`` — build-free from the
registry warm pool when armed — with a ``respawn`` mark in the journal;
a dead grid worker is the pool's own disclosed degraded N−1 respawn; a
dead broker is the pool's re-election. ``sweep()`` closes the hygiene
loop: any shm segment or doorbell fd the teardown hooks missed is
reclaimed and counted (``fmrp_topology_leaked_segments_total`` /
``fmrp_topology_leaked_fds_total``).

Exactly-once across a whole-controller crash: every topology change
writes a ``topology`` mark (the spec as JSON) into the fleet's request
journal; :meth:`TopologyController.recover` reads the LAST such mark
(``recover_journal``'s ``last_topology``), closes out in-flight
requests to typed retriable terminals, and rebuilds the declared shape
through ``ServingFleet.recover`` — clean replay, no kernel build
with a populated registry, any shape.

The autoscaler routes through here when attached: the controller sets
``fleet.topology = self`` and the supervisor's scale verbs prefer that
attribute, so elasticity updates the declared shape (and its journal
record) instead of drifting away from it.

Process replicas and grid workers run on the device the fleet or pool
was given (the GPU unless the caller asked for the CPU); a recovered
shape takes the same ``device=`` through ``fleet_kwargs``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, Optional, Tuple

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.topology.spec import TopologySpec

__all__ = ["Member", "TopologyController"]

# classifications the repair verb acts on
_REPAIRABLE = ("killed", "hung", "ring_stalled")


@dataclasses.dataclass(frozen=True)
class Member:
    """One row of the live inventory."""

    kind: str                  # router | replica_thread | replica_process
    #                          # | grid_worker | broker
    ident: str                 # rid / shard id / "router" / "exchange"
    pid: Optional[int]         # OS pid (None: in-process member)
    status: str                # live | killed | hung | ring_stalled |
    #                          # draining | dead | degraded | closed
    detail: str = ""


class TopologyController:
    """Supervise a :class:`ServingFleet` (router + replicas) and an
    optional :class:`SpecGridWorkerPool` (grid workers + broker) as one
    declared inventory. See the module docstring for the ladder/verbs."""

    def __init__(self, spec: TopologySpec, *, fleet, pool=None,
                 ping_timeout_s: Optional[float] = None):
        self.spec = spec
        self.fleet = fleet
        self.pool = pool
        if ping_timeout_s is None:
            ping_timeout_s = float(os.environ.get(
                "FMRP_TOPO_PING_TIMEOUT_S", "2.0"))
        self.ping_timeout_s = float(ping_timeout_s)
        # rid → (produced, consumed) from the previous probe: the
        # ring-stall classifier needs TWO samples to tell "backlog being
        # drained" from "backlog frozen"
        self._ring_marks: Dict[str, Tuple[int, int]] = {}
        self.last_probe: Dict[str, str] = {}
        reg = telemetry.registry()
        self._m_respawns = reg.counter(
            "fmrp_topology_respawns_total",
            help="members respawned by the topology controller",
        )
        self._g_respawn_s = reg.gauge(
            "fmrp_topology_last_respawn_s",
            help="seconds from classification to completed respawn "
                 "(last repair)",
        )
        # the autoscaler's scale verbs route through the controller so
        # elasticity keeps the declared shape (and its journal record)
        # current instead of silently diverging from it
        fleet.topology = self
        self._mark_topology()

    # -- journal record ----------------------------------------------------

    def _mark_topology(self) -> None:
        self.fleet._jrnl_mark(
            "topology",
            topo=json.dumps(self.spec.to_mark(), sort_keys=True),
            size=int(self.spec.replicas),
        )

    def _mark(self, label: str, **fields) -> None:
        self.fleet._jrnl_mark(label, **fields)

    # -- post-mortem flight harvest ----------------------------------------

    def flight(self, rid: str) -> Optional[dict]:
        """The flight-recorder tail the member mirrored into its shm
        annex: the fleet's cached harvest for departed replicas (the
        kill path harvests through SIGKILL), a live read otherwise.
        None when the member never mirrored (annex off / thread
        replica)."""
        cached = getattr(self.fleet, "flights", {}).get(rid)
        if cached is not None:
            return cached
        rep = self.fleet.replica(rid)
        harvest = getattr(rep.service, "harvest_flight", None) \
            if rep is not None else None
        return harvest() if harvest is not None else None

    def _flight_detail(self, rid: str) -> str:
        """Compact ``flight=...`` clause for :meth:`members` /
        ``respawn`` marks — last mirrored reason + last span name, the
        two facts a post-mortem reader wants before opening the full
        harvest."""
        flight = self.flight(rid)
        if not flight:
            return ""
        spans = flight.get("spans") or []
        last = spans[-1].get("name") if spans else None
        out = f"flight={flight.get('reason', '?')}"
        if last:
            out += f" last_span={last}"
        return out + f" spans={len(spans)}"

    # -- the live inventory ------------------------------------------------

    def members(self) -> List[Member]:
        rows = [Member(
            kind="router", ident="router", pid=os.getpid(),
            status="crashed" if getattr(self.fleet, "_crashed", False)
            else "live",
            detail=f"replicas={len(self.fleet.replica_states())}",
        )]
        probe = self.last_probe
        for rid, state in sorted(self.fleet.replica_states().items()):
            rep = self.fleet.replica(rid)
            svc = rep.service if rep is not None else None
            proc = getattr(svc, "proc", None)
            kind = "replica_process" if proc is not None else \
                "replica_thread"
            status = probe.get(rid, state if state != "healthy"
                               else "live")
            detail = f"transport={getattr(svc, 'transport', 'thread')}"
            if status in _REPAIRABLE or status == "dead":
                # the probe verdict carries its post-mortem: the flight
                # tail harvested from the member's shm annex (survives
                # SIGKILL — the mirror protocol is commit-last)
                fl = self._flight_detail(rid)
                if fl:
                    detail += f" {fl}"
            rows.append(Member(
                kind=kind, ident=rid,
                pid=getattr(svc, "pid", None),
                status=status,
                detail=detail,
            ))
        pool = self.pool
        if pool is not None:
            for shard, w in zip(pool._shard_ranks, pool.workers):
                rc = w.poll()
                rows.append(Member(
                    kind="grid_worker", ident=f"g{shard}", pid=w.pid,
                    status="live" if rc is None else "killed",
                    detail=f"rc={rc}" if rc is not None else "",
                ))
            for shard in pool.degraded_ranks:
                rows.append(Member(
                    kind="grid_worker", ident=f"g{shard}", pid=None,
                    status="degraded",
                    detail="shard lost; merges are disclosed "
                           "partial sums over survivors",
                ))
            rows.append(Member(
                kind="broker", ident="exchange", pid=os.getpid(),
                status="live",
                detail=f"rounds={pool.exchange._m_rounds.value}",
            ))
        return rows

    # -- the liveness ladder -----------------------------------------------

    def _ring_watermark(self, svc) -> Optional[Tuple[int, int]]:
        chan = getattr(svc, "_channel", None)
        if chan is None:
            return None
        try:
            return chan.req_ring.watermark()
        except Exception:  # noqa: BLE001 — a torn ring reads as absent
            return None

    def probe(self) -> Dict[str, str]:
        """Classify every replica: live | killed | ring_stalled | hung
        (process mode; thread replicas report the fleet's own state).
        One call = one watermark sample — ``ring_stalled`` needs two
        probes so a backlog being DRAINED is never misread as a stall."""
        out: Dict[str, str] = {}
        states = self.fleet.replica_states()
        for rid, state in states.items():
            rep = self.fleet.replica(rid)
            if rep is None or state == "dead":
                out[rid] = "dead"
                continue
            svc = rep.service
            proc = getattr(svc, "proc", None)
            if proc is None:
                # thread replica: in-process by construction — liveness
                # IS the fleet state
                out[rid] = "live" if state == "healthy" else state
                continue
            if proc.poll() is not None:
                out[rid] = "killed"
                self._ring_marks.pop(rid, None)
                continue
            wm = self._ring_watermark(svc)
            if wm is not None:
                prev = self._ring_marks.get(rid)
                self._ring_marks[rid] = wm
                produced, consumed = wm
                if (prev is not None and produced > consumed
                        and consumed == prev[1]):
                    out[rid] = "ring_stalled"
                    continue
            try:
                svc._call("ping", timeout=self.ping_timeout_s)
                out[rid] = "live"
            except _FutureTimeout:
                out[rid] = "hung"
            except Exception:  # noqa: BLE001 — dead socket = corpse
                out[rid] = "killed"
        self.last_probe = out
        return out

    # -- repair verbs ------------------------------------------------------

    def repair(self, probe: Optional[Dict[str, str]] = None) -> List[str]:
        """Respawn every non-live replica through the existing fleet
        machinery (kill → shm rings/doorbells torn down and unlinked →
        warm-pool replace → ``respawn`` journal mark). Grid-worker and
        broker deaths repair themselves inside ``pool.contract`` (the
        degraded N−1 / re-election paths); here they are disclosed via
        :meth:`members`. Returns the action log."""
        status = probe if probe is not None else self.probe()
        actions: List[str] = []
        for rid, st in sorted(status.items()):
            if st not in _REPAIRABLE:
                continue
            t0 = time.perf_counter()
            self.fleet.kill_replica(rid, reason=f"topology:{st}")
            new_rid = self.fleet.replace(rid, reason=f"topology:{st}")
            took = time.perf_counter() - t0
            self._ring_marks.pop(rid, None)
            self._mark("respawn", replica=rid, replacement=new_rid,
                       cause=st, flight=self._flight_detail(rid) or None)
            self._m_respawns.inc()
            self._g_respawn_s.set(took)
            actions.append(f"respawn:{rid}->{new_rid}:{st}")
        if actions:
            self._mark_topology()
        return actions

    def sweep(self) -> Dict[str, object]:
        """Reclaim anything the member teardown hooks missed: leaked shm
        segments (unlinked + counted) and doorbell eventfds (closed +
        counted). Call AFTER teardown — a live topology's segments are
        supposed to exist and would be reclaimed from under it."""
        from fm_returnprediction_tpu_torch.parallel.shm import sweep_segments
        from fm_returnprediction_tpu_torch.serving.shm import sweep_doorbells

        leaked_segs = sweep_segments()
        leaked_fds = sweep_doorbells()
        return {"segments": leaked_segs, "fds": leaked_fds}

    # -- elasticity (the autoscaler routes through here) -------------------

    def scale_out(self, n: int = 1, reason: str = "pressure") -> List[str]:
        rids = self.fleet.scale_out(n, reason=reason)
        if rids:
            self.spec = dataclasses.replace(
                self.spec, replicas=self.spec.replicas + len(rids))
            self._mark_topology()
        return rids

    def scale_in(self, reason: str = "relief") -> Optional[str]:
        rid = self.fleet.scale_in(reason=reason)
        if rid is not None and self.spec.replicas > 1:
            self.spec = dataclasses.replace(
                self.spec, replicas=self.spec.replicas - 1)
            self._mark_topology()
        return rid

    # -- crash-restart recovery --------------------------------------------

    @classmethod
    def recover(cls, journal, *, state=None, registry_dir=None,
                panel=None, spec: Optional[TopologySpec] = None,
                **fleet_kwargs):
        """Rebuild ANY declared shape from the journal alone.

        Reads the last ``topology`` mark (falling back to the plain
        ``size=`` marks for pre-topology journals), repairs + closes out
        the crashed session (``recover_journal`` — clean replay, typed
        retriable terminals), and rebuilds the fleet through
        ``ServingFleet.recover`` with the declared replica mode and
        transport — warm-pool spawns, no kernel build with a
        populated registry. A declared grid pool is rebuilt only when
        the caller supplies ``panel=(y, x, universes)`` (panels are
        data, not journal state), on the ``device`` of ``fleet_kwargs``
        (default the GPU); otherwise it is disclosed as pending in the
        returned report. Returns ``(controller, RecoveryReport)``.
        """
        from fm_returnprediction_tpu_torch.serving.fleet import ServingFleet
        from fm_returnprediction_tpu_torch.serving.recovery import recover_journal

        jrec = recover_journal(journal)
        if spec is None:
            if jrec.last_topology is not None:
                spec = TopologySpec.from_mark(jrec.last_topology)
            else:
                spec = TopologySpec(replicas=jrec.last_size or 1)
        fleet, report = ServingFleet.recover(
            journal, registry_dir=registry_dir, state=state,
            n_replicas=spec.replicas, replica_mode=spec.replica_mode,
            transport=spec.transport, **fleet_kwargs,
        )
        pool = None
        if spec.grid_procs and panel is not None:
            from fm_returnprediction_tpu_torch.specgrid.multiproc import SpecGridWorkerPool

            y, x, universes = panel
            pool_kw = {}
            if "device" in fleet_kwargs:
                pool_kw["device"] = str(fleet_kwargs["device"])
            pool = SpecGridWorkerPool(
                spec.grid_procs, y, x, universes,
                transport=spec.grid_transport, **pool_kw,
            )
        ctl = cls(spec, fleet=fleet, pool=pool)
        telemetry.event("topology.recovered", cat="topology",
                        replicas=spec.replicas,
                        replica_mode=spec.replica_mode,
                        grid_procs=spec.grid_procs,
                        grid_rebuilt=pool is not None)
        return ctl, report

    # -- lifecycle ---------------------------------------------------------

    def close(self, *, close_fleet: bool = True,
              close_pool: bool = True) -> None:
        if close_pool and self.pool is not None:
            self.pool.close()
        if close_fleet:
            self.fleet.close()

    def __enter__(self) -> "TopologyController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
