"""Process replicas: the serving fleet's replica boundary as a real
process behind a length-prefixed socket transport.

Each replica is a spawned Python process (``subprocess.Popen`` of a fresh
interpreter, never a fork of a process that holds CUDA) owning its own
``ERService`` (microbatcher, bucketed executor on its own CUDA graphs, SLO
monitor) and its own CUDA context on the card. The router talks to it
over the repo's one wire format, 8-byte big-endian length-prefixed pickle
frames (``parallel.distributed.send_frame``). Trusted local links only.

Protocol (every request frame carries a correlation ``id``):

=========== ================================================================
``hello``   child → parent once the service is warm: rid, pid, the
            ``WarmReport`` dict (a registry warm-pool start), the child's
            epoch anchor; or ``ok=False`` + error on a failed start.
``submit``  parent → child; the child answers twice: an immediate
            ``accept``/``reject`` (``reject`` carries the child batcher's
            ``QueueFullError`` evidence, or the pickled synchronous
            exception), then a ``result`` when the inner future resolves.
``stats``   one round trip to the child's ``ERService.stats()``: the
            supervisor's heartbeat (a dead process cannot answer).
``drain``   pump the child's batcher dry.
``prepare`` / ``commit``  the two-phase rollover: the candidate state
            ships as a ``ServingState`` bundle on the shared filesystem;
            the child warms in phase 1 and flips in phase 2.
``close``   graceful shutdown (drain, close, exit 0).
=========== ================================================================

Transports (``FMRP_FLEET_TRANSPORT=shm|socket``, default ``auto`` = shm
where POSIX shared memory works and fits): the table above is the control
plane and always rides the socket. In ``socket`` mode the data plane
(submit/accept/reject/result) rides it too, one pickled message per row,
kept as the oracle. In ``shm`` mode the data plane moves to a pair of
shared-memory frame rings (``serving.shm``).

The write-ahead journal stays in the router, so the exactly-once proof
covers a replica process kill: a SIGKILLed child drops its socket, the
reader thread fails every in-flight future with ``ReplicaDeadError``, and
the fleet's requeue machinery re-routes them. A child that never says
hello fails the spawn with :class:`ReplicaSpawnError`; the fleet never
falls back to a thread replica.
"""

from __future__ import annotations

import os
import pickle
import select
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Dict, Optional

from fm_returnprediction_tpu_torch.parallel.distributed import recv_frame, send_frame
from fm_returnprediction_tpu_torch.registry.warm import WarmReport
from fm_returnprediction_tpu_torch.resilience.errors import ReplicaDeadError
from fm_returnprediction_tpu_torch.serving.batcher import QueueFullError
from fm_returnprediction_tpu_torch.telemetry import spans as _spans

__all__ = ["ProcessReplica", "ReplicaSpawnError", "cleanup_scratch"]

_REPO_ROOT = str(Path(__file__).resolve().parents[2])

_STATE_ATTR = "_fmrp_proc_bundle"


class ReplicaSpawnError(RuntimeError):
    """A replica child failed to start (handshake timeout, bad hello)."""


def _ship_state(state, scratch: Path) -> Path:
    """The state bundle path every process replica of this version loads —
    written ONCE per state object (cached on the object itself: the fleet
    spawns N replicas and M failover replacements from the same version,
    and a rollover candidate prepares on every replica)."""
    cached = getattr(state, _STATE_ATTR, None)
    if cached is not None and Path(cached).exists():
        return Path(cached)
    scratch.mkdir(parents=True, exist_ok=True)
    fd, name = tempfile.mkstemp(suffix=".npz", prefix="state_",
                                dir=str(scratch))
    os.close(fd)
    path = state.save(name)
    try:
        object.__setattr__(state, _STATE_ATTR, str(path))
    except (AttributeError, TypeError):
        pass  # a slotted/frozen state just re-ships per spawn
    return Path(path)


class _RemoteBatcher:
    """The slice of the ``MicroBatcher`` surface the fleet reads on a
    replica it does not own: ``queue_depth`` (parent-side in-flight
    count — the admission snapshot must not RPC under the fleet lock),
    ``max_queue`` (from the spawn config), ``drain()`` (one RPC), and
    ``_thread`` (None: the flusher lives in the child; the supervisor's
    liveness check is the stats round trip itself)."""

    _thread = None

    def __init__(self, owner: "ProcessReplica", max_queue: int):
        self._owner = owner
        self.max_queue = int(max_queue)

    @property
    def queue_depth(self) -> int:
        return self._owner.inflight

    def drain(self) -> int:
        try:
            return int(self._owner._call("drain"))
        except ReplicaDeadError:
            return 0  # a corpse has nothing left to pump


class ProcessReplica:
    """Parent-side handle on one spawned replica process, mirroring the
    ``ERService`` surface the fleet drives: ``submit`` (sync
    ``QueueFullError``/``RuntimeError`` semantics preserved via the
    accept/reject round), ``stats``, ``kill``, ``close``,
    ``prepare_state``/``commit_state``, ``batcher.{queue_depth,max_queue,
    drain}``. ``slo`` is None parent-side — the monitor lives in the
    child and its verdict rides back in ``stats()['slo_state']``, which
    is what the supervisor's probe keys off."""

    slo = None

    def __init__(self, rid: str, state, *, scratch: Path,
                 service_kwargs: Optional[dict] = None,
                 registry_dir=None,
                 spawn_timeout_s: float = 180.0,
                 call_timeout_s: float = 120.0,
                 transport: Optional[str] = None):
        from fm_returnprediction_tpu_torch.parallel.shm import (
            transport_instruments,
        )
        from fm_returnprediction_tpu_torch.serving.shm import (
            resolve_fleet_transport,
        )

        from fm_returnprediction_tpu_torch.telemetry import (
            distributed as _obs,
        )

        self.replica_id = rid
        self.transport = resolve_fleet_transport(transport)
        self._call_timeout_s = float(call_timeout_s)
        self._dead: Optional[str] = None
        # post-mortem flight annex: parent-owned shm mailbox the child
        # mirrors its flight tail into — harvestable through SIGKILL
        self.annex = (_obs.FlightAnnex.create(rid)
                      if _obs.annex_enabled() else None)
        self.last_flight: Optional[dict] = None
        self.anchor_ns: Optional[int] = None
        #: set by the fleet: callable(rid, delta) feeding its aggregator
        self.metrics_sink = None
        self._wlock = threading.Lock()
        self._idlock = threading.Lock()
        self._next_id = 0
        self._n_inflight = 0  # submit entries in _pending (O(1) reads)
        # id → {"kind": "call"|"submit", "future": Future, "accept": Future}
        self._pending: Dict[int, dict] = {}
        kwargs = dict(service_kwargs or {})
        kwargs.pop("metric_labels", None)  # the child stamps its own
        max_queue = int(kwargs.get("max_queue", 1024))
        self.batcher = _RemoteBatcher(self, max_queue)
        # the SOCKET is always the control plane (and, in socket mode,
        # the data plane too) — its bytes count under transport=socket;
        # the shm rings carry their own transport=shm instruments, so
        # a socket-vs-shm comparison reads clean labels
        self._inst = transport_instruments("socket", rid)
        self._channel = None
        if self.transport == "shm":
            from fm_returnprediction_tpu_torch.serving.shm import (
                ShmReplicaChannel,
            )

            self._channel = ShmReplicaChannel(
                on_ack=self._deliver_ack,
                on_results=self._deliver_results,
                on_dead=self._mark_dead,
                replica_id=rid,
            )
        scratch = Path(scratch)
        state_path = _ship_state(state, scratch)
        listener = socket.create_server(("127.0.0.1", 0))
        listener.settimeout(spawn_timeout_s)
        port = listener.getsockname()[1]
        cfg = {
            "rid": rid,
            "port": port,
            "state_path": str(state_path),
            "registry_dir": str(registry_dir) if registry_dir else None,
            "service_kwargs": kwargs,
            "shm": (self._channel.describe()
                    if self._channel is not None else None),
            "annex": (self.annex.describe()
                      if self.annex is not None else None),
        }
        fd, cfg_path = tempfile.mkstemp(suffix=".pkl", prefix=f"{rid}_cfg_",
                                        dir=str(scratch))
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(cfg, fh)
        self.log_path = scratch / f"{rid}.log"
        env = dict(os.environ)
        # per-process telemetry identity: the replica's exports label
        # themselves process_index=<k> (identity.py's generic knob)
        digits = "".join(c for c in rid if c.isdigit())
        env["FMRP_PROC_INDEX"] = digits or "0"
        # an active FaultPlan crosses the spawn with the replica: the
        # worker's main() installs it, so chaos sites (shm.ring.commit,
        # replica verb stalls, ...) fire INSIDE the child deterministically
        from fm_returnprediction_tpu_torch.resilience.faults import chaos_env

        env.update(chaos_env())
        # trace context crosses the spawn: telemetry arming + trace dir
        # + the spawning span's identity (FMRP_TRACE_REMOTE), so the
        # child's root spans name their router parent
        _obs.trace_env(env)
        # the repo goes after what the caller put on the path
        env["PYTHONPATH"] = (env["PYTHONPATH"] + os.pathsep + _REPO_ROOT
                             if env.get("PYTHONPATH") else _REPO_ROOT)
        self._log_fh = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "fm_returnprediction_tpu_torch.serving.replica_worker", cfg_path],
            env=env, stdout=self._log_fh, stderr=subprocess.STDOUT,
            pass_fds=(self._channel.pass_fds()
                      if self._channel is not None else ()),
        )
        try:
            conn = self._await_hello(listener, spawn_timeout_s)
            hello = pickle.loads(recv_frame(conn))
        except (socket.timeout, OSError, EOFError, RuntimeError) as exc:
            self.proc.kill()
            self.proc.wait()
            self._stop_channel()
            self._release_annex()
            raise ReplicaSpawnError(
                f"replica {rid} never said hello within {spawn_timeout_s}s "
                f"({exc!r}); log: {self._log_tail()}"
            ) from exc
        finally:
            listener.close()
        if not hello.get("ok"):
            self.proc.kill()
            self.proc.wait()
            self._stop_channel()
            self._release_annex()
            raise ReplicaSpawnError(
                f"replica {rid} failed to start: {hello.get('error')}; "
                f"log: {self._log_tail()}"
            )
        conn.settimeout(None)
        self._sock = conn
        self.pid = int(hello["pid"])
        # clock alignment: the child's epoch anchor rides the hello —
        # recorded router-side as the monotonic-offset exchange evidence
        # the timeline merge verifies against
        self.anchor_ns = hello.get("anchor_ns")
        _obs.register_peer(rid, pid=self.pid, anchor_ns=self.anchor_ns,
                           kind="replica")
        warm = hello.get("warm")
        self.warm_report: Optional[WarmReport] = (
            WarmReport(**{**warm, "programs": tuple(warm["programs"])})
            if warm is not None else None
        )
        self._reader = threading.Thread(
            target=self._read_loop, name=f"fmrp-replica-{rid}", daemon=True
        )
        self._reader.start()

    # -- plumbing ----------------------------------------------------------

    def _await_hello(self, listener, timeout_s: float) -> socket.socket:
        """The child's connection, waited for with the child watched: one
        that exits before it connects fails the spawn at once, not after
        the whole budget; the connection then has the rest of the budget
        to deliver its hello."""
        deadline = time.monotonic() + timeout_s
        while not select.select([listener], [], [], 0.25)[0]:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica process exited with {self.proc.returncode} before hello")
            if time.monotonic() > deadline:
                raise socket.timeout(f"no connection within {timeout_s}s")
        conn, _ = listener.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(max(deadline - time.monotonic(), 1.0))
        return conn

    def _log_tail(self, n: int = 2000) -> str:
        try:
            data = Path(self.log_path).read_bytes()
            return data[-n:].decode(errors="replace")
        except OSError:
            return "<no log>"

    @property
    def inflight(self) -> int:
        return self._n_inflight  # int read: atomic enough for a gauge

    def _stop_channel(self) -> None:
        if self._channel is not None:
            try:
                self._channel.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    def harvest_flight(self) -> Optional[dict]:
        """Read the child's last committed flight mirror out of the shm
        annex and cache it on this handle — callable before OR after the
        child is dead (SIGKILL included: the annex is parent-owned shm,
        and the mirror protocol commits last, so a kill mid-mirror
        leaves the previous tail whole). Returns the cached flight."""
        if self.annex is not None:
            flight = None
            try:
                flight = self.annex.harvest()
            except Exception:  # noqa: BLE001 — a torn annex reads absent
                flight = None
            if flight is not None:
                self.last_flight = flight
        return self.last_flight

    def _release_annex(self) -> None:
        if self.annex is None:
            return
        try:
            self.annex.release()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        self.annex = None

    def _send(self, msg: dict) -> None:
        if self._dead is not None:
            raise ReplicaDeadError(self._dead)
        try:
            payload = pickle.dumps(msg)
            send_frame(self._sock, payload, self._wlock)
            self._inst["bytes_out"].inc(len(payload))
            self._inst["frames"].inc()
        except OSError as exc:
            self._mark_dead(f"replica {self.replica_id} socket write "
                            f"failed: {exc!r}")
            raise ReplicaDeadError(self._dead) from exc

    def _register(self, kind: str, accept: bool = True) -> dict:
        # accept=False (the shm data plane): admission is optimistic, so
        # no second Future is ever waited on — skipping it saves a
        # threading.Condition construction per request on the hot path
        with self._idlock:
            self._next_id += 1
            entry = {"id": self._next_id, "kind": kind,
                     "future": Future(),
                     "accept": Future() if accept else None}
            self._pending[self._next_id] = entry
            if kind == "submit":
                self._n_inflight += 1
            return entry

    def _pop(self, req_id: int) -> Optional[dict]:
        """Remove one pending entry (inflight accounting in one place)."""
        with self._idlock:
            entry = self._pending.pop(req_id, None)
            if entry is not None and entry["kind"] == "submit":
                self._n_inflight -= 1
            return entry

    def _mark_dead(self, why: str) -> None:
        with self._idlock:
            if self._dead is not None:
                return
            self._dead = why
            pending = list(self._pending.values())
            self._pending.clear()
            self._n_inflight = 0
        # post-mortem harvest FIRST, then release the segment — the
        # flight stays cached on the handle (the fleet's ``flights``)
        self.harvest_flight()
        self._release_annex()
        self._stop_channel()
        try:
            if getattr(self, "_sock", None) is not None:
                self._sock.close()
        except OSError:
            pass
        try:
            self._log_fh.close()
        except OSError:
            pass
        # fail the in-flight work OUTSIDE the lock: the futures'
        # done-callbacks are the fleet's requeue path, which re-enters
        # submit on another replica
        exc = ReplicaDeadError(why)
        for e in pending:
            if e["accept"] is not None and not e["accept"].done():
                e["accept"].set_exception(exc)
            if not e["future"].done():
                e["future"].set_exception(exc)

    def _read_loop(self) -> None:
        try:
            while True:
                raw = recv_frame(self._sock)
                self._inst["bytes_in"].inc(len(raw))
                msg = pickle.loads(raw)
                op = msg.get("op")
                if _spans.active() and msg.get("t_ns"):
                    _spans.record_span("hop.transport_resp",
                                       msg["t_ns"], op=op)
                with self._idlock:
                    entry = self._pending.get(msg.get("id"))
                if entry is None:
                    continue
                if op == "accept":
                    entry["accept"].set_result(None)
                elif op == "reject":
                    self._pop(entry["id"])
                    entry["accept"].set_exception(self._reject_exc(msg))
                elif op == "result":
                    t_recv = (time.perf_counter_ns()
                              if _spans.active() else 0)
                    self._pop(entry["id"])
                    if not entry["accept"].done():
                        entry["accept"].set_result(None)
                    if msg.get("ok"):
                        entry["future"].set_result(msg.get("value"))
                    else:
                        entry["future"].set_exception(
                            self._unpickle_exc(msg)
                        )
                    if t_recv:
                        _spans.record_span("hop.complete", t_recv,
                                           req=entry["id"])
        except Exception as exc:  # noqa: BLE001 — EOF/OSError: child died
            self._mark_dead(
                f"replica {self.replica_id} process died "
                f"(transport: {type(exc).__name__})"
            )

    @staticmethod
    def _reject_exc(msg: dict) -> BaseException:
        kind = msg.get("kind")
        if kind == "queue_full":
            return QueueFullError(
                msg.get("message", "replica queue full"),
                queue_depth=msg.get("queue_depth"),
                max_queue=msg.get("max_queue"),
            )
        if kind == "closed":
            return RuntimeError(msg.get("message", "batcher is closed"))
        return ProcessReplica._unpickle_exc(msg)

    @staticmethod
    def _unpickle_exc(msg: dict) -> BaseException:
        blob = msg.get("exc")
        if blob is not None:
            try:
                exc = pickle.loads(blob)
                if isinstance(exc, BaseException):
                    return exc
            except Exception:  # noqa: BLE001 — fall through to repr
                pass
        return RuntimeError(msg.get("error", "replica-side failure"))

    # -- shm data-plane delivery (the channel's reader thread) --------------

    def _deliver_ack(self, req_id: int, status: int,
                     evidence: Optional[dict]) -> None:
        """A replica-side REJECT (or a parent-side transport failure):
        under the optimistic-accept protocol these are the rare path —
        the error lands on the request's FUTURE (the accept resolved at
        submit time), which is where the fleet's done-callback picks
        request-shaped failures up."""
        from fm_returnprediction_tpu_torch.serving import shm as _shm

        entry = self._pop(req_id)
        if entry is None:
            return
        ev = evidence or {}
        if status == _shm.STATUS_QUEUE_FULL:
            # requeueable on the future path (fleet._REQUEUEABLE): the
            # synchronous submit already admitted optimistically, so a
            # child-side backpressure disagreement reroutes like the
            # socket mode's sync QueueFullError would have
            exc: BaseException = QueueFullError(
                ev.get("message", "replica queue full"),
                queue_depth=ev.get("queue_depth"),
                max_queue=ev.get("max_queue"),
            )
        elif status == _shm.STATUS_CLOSED:
            # a closed child batcher means the replica is going away —
            # ReplicaDeadError is the fleet's requeue-and-replace signal
            # (the socket mode's sync RuntimeError path reroutes too)
            exc = ReplicaDeadError(
                ev.get("message", "replica batcher is closed"))
        elif "overload" in ev:
            exc = ev["overload"]  # parent-side ring-full: typed 429
        else:
            exc = self._unpickle_exc(ev)
        accept = entry["accept"]
        if accept is not None and not accept.done():
            accept.set_exception(exc)
        elif not entry["future"].done():
            entry["future"].set_exception(exc)

    def _deliver_results(self, rows) -> None:
        """One RESULT frame's rows → resolved futures (entries popped
        under a single lock acquisition; future resolution outside it —
        done-callbacks re-enter the fleet)."""
        with self._idlock:
            entries = []
            for rid, ok, value in rows:
                entry = self._pending.pop(rid, None)
                if entry is not None:
                    if entry["kind"] == "submit":
                        self._n_inflight -= 1
                    entries.append((entry, ok, value))
        for entry, ok, value in entries:
            accept = entry["accept"]
            if accept is not None and not accept.done():
                accept.set_result(None)
            if ok:
                entry["future"].set_result(value)
            else:
                entry["future"].set_exception(self._unpickle_exc(value))

    # -- the ERService mirror ----------------------------------------------

    def submit(self, month, x) -> Future:
        """Async query via the child. Synchronous-raise semantics match
        the in-process service: ``QueueFullError`` under child
        backpressure, ``RuntimeError`` when the child batcher is closed,
        the child's own synchronous exception (e.g. ``KeyError`` for an
        unknown month) re-raised here; a dead process raises
        ``RuntimeError`` (the fleet's replica_closed requeue signal)."""
        if self._dead is not None:
            raise RuntimeError(f"replica process is dead: {self._dead}")
        if self._channel is not None:
            # shm data plane, optimistic accept: the parent enforces the
            # SAME max_queue ceiling the child batcher would (sync
            # QueueFullError → the fleet tries another replica), then
            # the row joins the pending strip and the caller gets its
            # future without a boundary round trip. A child-side
            # disagreement (racing swap, malformed row) comes back as an
            # ACK-reject and lands on the future — request-shaped, the
            # fleet's done-callback semantics.
            if self._n_inflight >= self.batcher.max_queue:
                raise QueueFullError(
                    f"replica {self.replica_id} transport window full "
                    f"({self._n_inflight}/{self.batcher.max_queue})",
                    queue_depth=self._n_inflight,
                    max_queue=self.batcher.max_queue,
                )
            entry = self._register("submit", accept=False)
            try:
                self._channel.submit_row(entry["id"], month, x)
            except BaseException as exc:
                self._pop(entry["id"])
                if isinstance(exc, RuntimeError):
                    raise
                raise RuntimeError(
                    f"replica process is dead: {exc}") from exc
            return entry["future"]
        entry = self._register("submit")
        msg = {"op": "submit", "id": entry["id"], "month": month, "x": x}
        if _spans.active():
            # socket-mode parity with the shm frame header stamps: send
            # time + the submitting span's identity ride the dict
            cur = _spans.current_span()
            msg["t_ns"] = time.perf_counter_ns()
            if cur is not None:
                msg["trace"] = (cur.trace_id, cur.span_id)
        try:
            self._send(msg)
            if msg.get("t_ns") and _spans.active():
                # hop.coalesce, socket flavor: message built → bytes on
                # the wire (pickle + the write-lock wait) — the same
                # enqueue→transport-handoff seam the shm strip measures
                _spans.record_span("hop.coalesce", msg["t_ns"],
                                   req=entry["id"])
            entry["accept"].result(timeout=self._call_timeout_s)
        except ReplicaDeadError as exc:
            self._pop(entry["id"])
            raise RuntimeError(f"replica process is dead: {exc}") from exc
        except BaseException:
            self._pop(entry["id"])
            raise
        return entry["future"]

    def _call(self, op: str, timeout: Optional[float] = None, **fields):
        """One synchronous round trip (stats/drain/prepare/commit/close)."""
        if self._dead is not None:
            raise ReplicaDeadError(self._dead)
        entry = self._register("call")
        try:
            self._send({"op": op, "id": entry["id"], **fields})
            return entry["future"].result(
                timeout=timeout if timeout is not None
                else self._call_timeout_s
            )
        finally:
            self._pop(entry["id"])

    def stats(self) -> dict:
        out = dict(self._call("stats"))
        # the stats heartbeat doubles as the metric-aggregation wire:
        # the child attaches its delta-encoded registry snapshot and the
        # fleet's aggregator (metrics_sink) folds it under {proc=rid}
        delta = out.pop("metrics_delta", None)
        if delta and self.metrics_sink is not None:
            try:
                self.metrics_sink(self.replica_id, delta)
            except Exception:  # noqa: BLE001 — stats must stay a probe
                pass
        out["proc_pid"] = self.pid
        out["proc_inflight"] = self.inflight
        out["transport"] = self.transport
        return out

    def prepare_state(self, new_state):
        """Phase 1 over the wire: ship the candidate bundle, the child
        builds + fully warms its executor without publishing. The token
        is child-side; the parent's opaque handle is just the rid."""
        path = _ship_state(new_state, Path(self.log_path).parent)
        self._call("prepare", state_path=str(path))
        return ("proc-prepared", self.replica_id)

    def commit_state(self, prepared) -> None:
        self._call("commit")

    def kill(self, reason: str = "replica killed") -> int:
        """Abrupt death: SIGKILL the child. In-flight requests fail with
        ``ReplicaDeadError`` (the fleet requeues on that signal); returns
        how many were stranded."""
        stranded = self.inflight
        try:
            self.proc.kill()
        except OSError:
            pass
        self._mark_dead(f"replica {self.replica_id} killed: {reason}")
        return stranded

    def release(self, timeout: float = 10.0) -> None:
        """The fleet's release of a leaving replica: the child process (and
        with it its CUDA context, graphs and state on the card) is gone
        when this returns. Idempotent; a live child is killed."""
        if self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        if self._dead is None:
            self._mark_dead(f"replica {self.replica_id} released")

    def close(self, timeout: float = 30.0) -> None:
        """Graceful: ask the child to drain + close + exit; escalate to
        kill if it does not comply in time."""
        if self._dead is None:
            try:
                self._call("close", timeout=timeout)
            except Exception:  # noqa: BLE001 — already dying is fine
                pass
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10.0)
        self._mark_dead(f"replica {self.replica_id} closed")


def cleanup_scratch(scratch: Optional[Path]) -> None:
    """Best-effort removal of a fleet's process-mode scratch tree."""
    if scratch is not None:
        shutil.rmtree(scratch, ignore_errors=True)
