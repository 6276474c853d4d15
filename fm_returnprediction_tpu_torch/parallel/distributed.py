"""Multi-process bootstrap and the host-side sufficient-stats exchange.

Process count is a deployment knob: the spec-grid worker pool and the
serving fleet's replica processes ask this module "who am I, how many of
us are there, and how do I merge with the others".

The transport is the **host exchange** (:class:`HostExchange`): a small
length-prefixed TCP allgather among the processes, rank 0 embedding the
server. Per-process Gram shards are additive over firms given a fixed
center, so ``sum_tree`` (allgather, then a rank-ordered summation
computed identically on every rank) stands in for a device all-reduce:
deterministic, and held against the single-process contraction
(``tests/test_torch_multiprocess.py``). Device collectives across
processes (the reference's ``FMRP_DIST_JAX``) serve the device mesh:
``FMRP_DIST_JAX=1`` also brings up ``torch.distributed``
(``parallel.multihost.initialize_multihost``, its store on the
coordinator's port + 1), ``auto`` does so only where a CUDA device is
available, ``0`` never.

Wire format, byte for byte the reference's: every frame is an 8-byte
big-endian length followed by a pickled payload (trusted intra-cluster
links only). One allgather round: every rank sends ``(rank, seq, bytes,
root)``, the server buffers until all ``world`` ranks posted that
``seq``, then sends each rank the rank-ordered list. Rounds complete in
``seq`` order. Byte and round counters land in the metrics registry
(``fmrp_dist_exchange_*``).

Configuration (``FMRP_DIST_*``, mirrored by :class:`DistConfig`):
``FMRP_DIST_COORDINATOR`` (``host:port`` of rank 0's server),
``FMRP_DIST_PROCS`` (world size), ``FMRP_DIST_PROC_ID`` (this rank),
``FMRP_DIST_JAX`` (``0``/``1``/``auto``, see above).

``initialize_distributed()`` is idempotent and a no-op when the
environment is not set. It also stamps the process's telemetry identity
(``telemetry.identity``), so merged traces and exports from N processes
stay attributable.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import select
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

from fm_returnprediction_tpu_torch.resilience.errors import InjectedFault
from fm_returnprediction_tpu_torch.resilience.faults import fault_site

__all__ = [
    "DistConfig",
    "DistributedError",
    "HostExchange",
    "apply_cpu_affinity_from_env",
    "dist_active",
    "free_port",
    "host_exchange",
    "initialize_distributed",
    "process_count",
    "process_index",
    "recv_frame",
    "run_rounds",
    "send_frame",
    "shutdown_distributed",
    "worker_env",
]

_LEN = struct.Struct(">Q")

# round-frame seq announcing a graceful client departure (vs a death,
# which arrives as bare EOF and tears the whole exchange down)
_BYE_SEQ = -1


class DistributedError(RuntimeError):
    """A host-exchange protocol failure (timeout, peer death, tag skew)."""


def free_port() -> int:
    """An OS-assigned free TCP port (for spawning local workers)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _send_frame(sock: socket.socket, payload: bytes, lock=None) -> int:
    data = _LEN.pack(len(payload)) + payload
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)
    return len(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise DistributedError("exchange peer closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, n)


# the one wire format: the exchange above and the serving fleet's replica
# transport (``serving.replica_proc``) share it
send_frame = _send_frame
recv_frame = _recv_frame


def _tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested tuples, lists, dicts and
    namedtuples (every other object is a leaf), in step with ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *leaves) for leaves in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """One process's distributed coordinates."""

    coordinator: str            # "host:port" of rank 0's exchange server
    num_processes: int
    process_id: int
    jax_collectives: str = "0"  # the reference's device-collective knob

    @classmethod
    def from_env(cls, environ=None) -> Optional["DistConfig"]:
        """``FMRP_DIST_COORDINATOR`` + ``FMRP_DIST_PROCS`` +
        ``FMRP_DIST_PROC_ID``; None (single-process) unless the first two
        are both set."""
        env = os.environ if environ is None else environ
        coord = env.get("FMRP_DIST_COORDINATOR", "").strip()
        procs = env.get("FMRP_DIST_PROCS", "").strip()
        if not coord or not procs:
            return None
        return cls(
            coordinator=coord,
            num_processes=int(procs),
            process_id=int(env.get("FMRP_DIST_PROC_ID", "0")),
            jax_collectives=env.get("FMRP_DIST_JAX", "0").strip() or "0",
        )

    @property
    def host(self) -> str:
        return self.coordinator.rsplit(":", 1)[0]

    @property
    def port(self) -> int:
        return int(self.coordinator.rsplit(":", 1)[1])


def worker_env(rank: int, world: int, port: int, host: str = "127.0.0.1",
               jax_collectives: str = "0", base: Optional[dict] = None) -> Dict[str, str]:
    """The child-process environment for one exchange worker: the one
    place the ``FMRP_DIST_*`` spelling lives for spawners. An active
    fault plan (``resilience.faults.chaos_env``) and the trace context
    (``telemetry.distributed.trace_env``) cross with it."""
    from fm_returnprediction_tpu_torch.resilience.faults import chaos_env
    from fm_returnprediction_tpu_torch.telemetry.distributed import trace_env

    env = dict(os.environ if base is None else base)
    env["FMRP_DIST_COORDINATOR"] = f"{host}:{port}"
    env["FMRP_DIST_PROCS"] = str(world)
    env["FMRP_DIST_PROC_ID"] = str(rank)
    env["FMRP_DIST_JAX"] = jax_collectives
    env.update(chaos_env())
    trace_env(env)
    return env


# retry-on allowlist for joining the exchange: a slow-starting rank 0 is
# the expected cold-start shape (connection refused until it binds)
_CONNECT_RETRY_ON = (ConnectionError, socket.timeout, OSError)


# -- the exchange server (embedded in rank 0) --------------------------------


class _ExchangeServer:
    """Rank 0's round broker: accepts ``world`` rank connections, buffers
    each round until every rank posted, answers in strict seq order."""

    def __init__(self, host: str, port: int, world: int, accept_timeout_s: float):
        self.world = int(world)
        self._listener = socket.create_server((host, port), reuse_port=False)
        self._listener.settimeout(accept_timeout_s)
        self._conns: Dict[int, socket.socket] = {}
        self._wlocks: Dict[int, threading.Lock] = {}
        self._lock = threading.Lock()
        self._rounds: Dict[int, Dict[int, tuple]] = {}
        self._next_seq = 1
        self._fail: Optional[str] = None
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fmrp-exchange-accept", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        try:
            while len(self._conns) < self.world:
                conn, _ = self._listener.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello = pickle.loads(_recv_frame(conn))
                rank = int(hello["rank"])
                with self._lock:
                    if rank in self._conns:
                        raise DistributedError(f"duplicate rank {rank}")
                    self._conns[rank] = conn
                    self._wlocks[rank] = threading.Lock()
                # the join hello carries each peer's epoch anchor, the
                # evidence the timeline merge aligns clocks with
                if hello.get("anchor_ns") is not None:
                    from fm_returnprediction_tpu_torch.telemetry.distributed import (
                        register_peer,
                    )

                    register_peer(f"rank{rank}", pid=hello.get("pid"),
                                  anchor_ns=hello.get("anchor_ns"), kind="rank")
            # all present: release everyone (the startup barrier)
            ok = pickle.dumps({"ok": True, "world": self.world})
            for rank, conn in self._conns.items():
                _send_frame(conn, ok, self._wlocks[rank])
                t = threading.Thread(target=self._reader, args=(rank, conn),
                                     name=f"fmrp-exchange-r{rank}", daemon=True)
                t.start()
                self._threads.append(t)
        except Exception as exc:  # noqa: BLE001 — surfaced to every rank
            self._die(f"exchange server accept failed: {exc!r}")

    def _die(self, why: str) -> None:
        """One rank's death is everyone's: a blocked allgather can never
        complete, so every connection is torn down (peers see EOF and
        raise) rather than letting the world hang in recv. ``shutdown``
        before ``close``: our own reader threads sit in ``recv`` on these
        sockets, and a bare close sends no FIN while they do."""
        with self._lock:
            if self._fail is None:
                self._fail = why
            conns = list(self._conns.values())
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _reader(self, rank: int, conn: socket.socket) -> None:
        try:
            while True:
                rank_in, seq, payload, root = pickle.loads(_recv_frame(conn))
                if seq == _BYE_SEQ:
                    # graceful leave, announced before the socket closes:
                    # a departure, not a death
                    with self._lock:
                        self._conns.pop(rank, None)
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                # the broker dying after a rank posted its round and
                # before the fan-out: _die tears every rank down (a typed
                # DistributedError, never a hang)
                fault_site("dist.broker_round")
                with self._lock:
                    bucket = self._rounds.setdefault(int(seq), {})
                    bucket[int(rank_in)] = (payload, root)
                    done = []
                    # complete strictly in seq order
                    while len(self._rounds.get(self._next_seq, {})) == self.world:
                        full = self._rounds.pop(self._next_seq)
                        roots = {r for _, r in full.values()}
                        if len(roots) != 1:
                            raise DistributedError(
                                f"round {self._next_seq} root skew: {roots}")
                        done.append((self._next_seq,
                                     [full[r][0] for r in range(self.world)],
                                     roots.pop()))
                        self._next_seq += 1
                for seq_done, ordered, root_done in done:
                    # root=None: allgather; root=k: gather (only rank k
                    # receives the list, the rest a completion ack)
                    full_reply = pickle.dumps((seq_done, ordered))
                    ack_reply = (pickle.dumps((seq_done, []))
                                 if root_done is not None else full_reply)
                    # rank 0 last: it embeds this server, and an error
                    # raised off its reply may close the exchange
                    with self._lock:
                        conns = sorted(self._conns.items(), key=lambda kv: kv[0] == 0)
                    for r, c in conns:
                        reply = (full_reply if root_done is None or r == root_done
                                 else ack_reply)
                        _send_frame(c, reply, self._wlocks[r])
        except (DistributedError, OSError, EOFError, pickle.PickleError, InjectedFault):
            self._die(f"rank {rank} left the exchange")

    def close(self) -> None:
        self._die("server closed")
        try:
            self._listener.close()
        except OSError:
            pass


# -- the per-process exchange client -----------------------------------------


class HostExchange:
    """One process's handle on the host-merge transport.

    ``allgather`` is the primitive; ``sum_tree``, ``barrier`` and
    ``broadcast_obj`` build on it client-side, so every rank computes the
    same rank-ordered result. One round at a time per process (the round
    lock); concurrent rounds from one process would deadlock the seq
    order, so they serialize here.
    """

    def __init__(self, config: DistConfig, timeout_s: Optional[float] = None,
                 watch: Optional[Callable[[], Optional[str]]] = None):
        from fm_returnprediction_tpu_torch import telemetry

        self.config = config
        self.rank = int(config.process_id)
        self.world = int(config.num_processes)
        if timeout_s is None:
            timeout_s = float(os.environ.get("FMRP_DIST_TIMEOUT_S", "120"))
        self.timeout_s = timeout_s
        # a spawner's probe while the world forms: a non-None answer (a
        # child that exited before joining) fails the join at once
        self._watch = watch
        self._server: Optional[_ExchangeServer] = None
        if self.rank == 0:
            self._server = _ExchangeServer(config.host, config.port, self.world, timeout_s)
        try:
            self._sock = self._connect()
        except BaseException:
            if self._server is not None:
                self._server.close()
            raise
        self._seq = 0
        self._round_lock = threading.Lock()
        self._wlock = threading.Lock()
        reg = telemetry.registry()
        self._m_bytes_out = reg.counter(
            "fmrp_dist_exchange_bytes_total",
            help="host-exchange payload bytes by direction", direction="sent")
        self._m_bytes_in = reg.counter(
            "fmrp_dist_exchange_bytes_total",
            help="host-exchange payload bytes by direction", direction="received")
        self._m_rounds = reg.counter(
            "fmrp_dist_exchange_rounds_total",
            help="completed host-exchange allgather rounds")
        self.last_round_s = 0.0

    def _connect(self) -> socket.socket:
        """Join the exchange through ``resilience.call_with_retry``:
        deterministic backoff seeded by rank, an attempt budget derived
        from ``timeout_s`` by accumulating the policy's own schedule, and
        exhaustion surfaced as a ``DistributedError``."""
        from fm_returnprediction_tpu_torch.resilience.errors import RetryExhaustedError
        from fm_returnprediction_tpu_torch.resilience.retry import (
            RetryPolicy,
            call_with_retry,
        )
        from fm_returnprediction_tpu_torch.telemetry import spans as _spans

        label = f"dist.connect.r{self.rank}"
        policy = RetryPolicy(max_attempts=2, backoff_s=0.05, multiplier=1.5,
                             max_backoff_s=2.0, jitter=0.1,
                             retry_on=_CONNECT_RETRY_ON, seed=self.rank)
        attempts, spent = 1, 0.0
        while attempts < 256:
            step = policy.delay_s(attempts, label)
            if spent + step > self.timeout_s:
                break
            spent += step
            attempts += 1
        policy = dataclasses.replace(policy, max_attempts=max(attempts, 2))

        def attempt() -> socket.socket:
            sock = socket.create_connection((self.config.host, self.config.port),
                                            timeout=self.timeout_s)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _send_frame(sock, pickle.dumps({
                    "rank": self.rank, "pid": os.getpid(),
                    "anchor_ns": _spans.EPOCH_ANCHOR_NS,
                }))
                self._await_world(sock)
                ok = pickle.loads(_recv_frame(sock))
                if not ok.get("ok") or ok.get("world") != self.world:
                    raise DistributedError(f"bad exchange handshake: {ok}")
                sock.settimeout(self.timeout_s)
            except BaseException:
                sock.close()
                raise
            return sock

        try:
            return call_with_retry(attempt, policy, label=label)
        except RetryExhaustedError as exc:
            raise DistributedError(
                f"rank {self.rank} could not join exchange at "
                f"{self.config.coordinator} within {self.timeout_s}s "
                f"({policy.max_attempts} attempts): {exc.__cause__!r}") from exc

    def _await_world(self, sock: socket.socket) -> None:
        """Wait for the startup barrier's reply, asking ``watch`` between
        polls (no-op without one)."""
        if self._watch is None:
            return
        deadline = time.monotonic() + self.timeout_s
        while not select.select([sock], [], [], 0.25)[0]:
            why = self._watch()
            if why:
                raise DistributedError(why)
            if time.monotonic() > deadline:
                raise DistributedError(
                    f"the exchange world of {self.world} did not form within "
                    f"{self.timeout_s}s")

    # -- primitives --------------------------------------------------------

    def allgather(self, payload: bytes, root: Optional[int] = None) -> List[bytes]:
        """One round: every rank contributes ``payload``. With
        ``root=None`` every rank receives the rank-ordered list of all
        contributions; with ``root=k`` only rank k receives it and the
        others get ``[]`` (a gather). All ranks of a round must agree on
        ``root`` (the broker raises on skew)."""
        with self._round_lock:
            self._seq += 1
            seq = self._seq
            t0 = time.perf_counter()
            msg = pickle.dumps((self.rank, seq, payload, root))
            sent = _send_frame(self._sock, msg, self._wlock)
            try:
                raw = _recv_frame(self._sock)
            except (OSError, socket.timeout) as exc:
                raise DistributedError(
                    f"exchange round {seq} failed on rank {self.rank}: {exc!r}") from exc
            seq_done, ordered = pickle.loads(raw)
            if seq_done != seq:
                raise DistributedError(f"exchange answered round {seq_done}, expected {seq}")
            self.last_round_s = time.perf_counter() - t0
            self._m_bytes_out.inc(sent)
            self._m_bytes_in.inc(len(raw))
            self._m_rounds.inc()
            return ordered

    def barrier(self, tag: str = "") -> None:
        """Rendezvous; mismatched tags raise (program-order divergence)."""
        tags = self.allgather(tag.encode())
        if any(t != tags[0] for t in tags):
            raise DistributedError(
                f"barrier tag skew: {sorted(set(t.decode() for t in tags))}")

    def allgather_obj(self, obj) -> list:
        return [pickle.loads(b) for b in self.allgather(pickle.dumps(obj))]

    def gather_obj(self, obj, root: int = 0) -> list:
        """Rank ``root`` returns every rank's object in rank order; every
        other rank returns ``[]``."""
        parts = self.allgather(pickle.dumps(obj), root=root)
        return [pickle.loads(b) for b in parts]

    def broadcast_obj(self, obj, root: int = 0):
        """Every rank receives ``root``'s object (non-root contributions
        are ignored)."""
        parts = self.allgather(pickle.dumps(obj) if self.rank == root else b"")
        return pickle.loads(parts[root])

    def sum_tree(self, tree):
        """Allgather a tree of numpy arrays and sum leaf-wise in rank
        order, in the leaves' own dtype: every rank computes the same
        left-to-right fold, so all ranks hold the same bits."""
        import numpy as np

        trees = self.allgather_obj(_tree_map(np.asarray, tree))
        out = trees[0]
        for t in trees[1:]:
            out = _tree_map(np.add, out, t)
        return out

    def close(self) -> None:
        # announce the departure before closing, so the broker can tell a
        # finished rank from a dead one
        try:
            bye = pickle.dumps((self.rank, _BYE_SEQ, b"", None))
            _send_frame(self._sock, bye, self._wlock)
        except (OSError, pickle.PickleError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._server is not None:
            self._server.close()


# -- process-wide bootstrap --------------------------------------------------

_STATE_LOCK = threading.Lock()
_EXCHANGE: Optional[HostExchange] = None
_COORDS: Optional[tuple] = None  # (process_id, num_processes)


def dist_active() -> bool:
    """True when this process joined a multi-process run."""
    return _EXCHANGE is not None


def host_exchange() -> Optional[HostExchange]:
    """The process's exchange client, or None (single-process)."""
    return _EXCHANGE


def process_index() -> int:
    """This process's rank."""
    if _COORDS is not None:
        return _COORDS[0]
    cfg = DistConfig.from_env()
    return cfg.process_id if cfg is not None else 0


def process_count() -> int:
    if _COORDS is not None:
        return _COORDS[1]
    cfg = DistConfig.from_env()
    return cfg.num_processes if cfg is not None else 1


def _want_collectives(cfg: DistConfig) -> bool:
    """``FMRP_DIST_JAX``: ``1`` brings up device collectives across
    processes (``torch.distributed``, the device mesh's transport), ``auto``
    only where a CUDA device is available (the reference's "only off-CPU"),
    ``0`` never; another value raises."""
    mode = cfg.jax_collectives.strip().lower()
    if mode not in ("0", "1", "auto"):
        raise ValueError(f"FMRP_DIST_JAX must be 0, 1 or auto, got {cfg.jax_collectives!r}")
    if mode == "auto":
        import torch

        return torch.cuda.is_available()
    return mode == "1"


def initialize_distributed(config: Optional[DistConfig] = None) -> tuple:
    """Join the multi-process run this process was launched into.

    Reads :class:`DistConfig` from ``FMRP_DIST_*`` when not given; a
    missing config is the single-process no-op ``(0, 1)``. Otherwise it
    installs a fault plan that rode the spawn environment, brings up the
    host exchange (rank 0 embeds the server; the startup rendezvous is
    the cluster barrier), brings up ``torch.distributed`` where
    ``FMRP_DIST_JAX`` asks for it (``_want_collectives``) and stamps the
    telemetry identity. Idempotent; returns ``(process_index,
    process_count)``."""
    global _EXCHANGE, _COORDS
    with _STATE_LOCK:
        if _EXCHANGE is not None:
            return _COORDS
        cfg = config if config is not None else DistConfig.from_env()
        if cfg is None:
            return (0, 1)
        collectives = _want_collectives(cfg)
        from fm_returnprediction_tpu_torch.resilience.faults import install_plan_from_env
        from fm_returnprediction_tpu_torch.telemetry import identity

        install_plan_from_env()
        exchange = HostExchange(cfg)
        if collectives:
            from fm_returnprediction_tpu_torch.parallel.multihost import initialize_multihost

            initialize_multihost(coordinator_address=f"{cfg.host}:{cfg.port + 1}",
                                 num_processes=cfg.num_processes, process_id=cfg.process_id)
        identity.set_process_index(cfg.process_id)
        _EXCHANGE = exchange
        _COORDS = (cfg.process_id, cfg.num_processes)
        return _COORDS


def shutdown_distributed() -> None:
    """Leave the exchange."""
    global _EXCHANGE, _COORDS
    with _STATE_LOCK:
        if _EXCHANGE is not None:
            _EXCHANGE.close()
        _EXCHANGE = None
        _COORDS = None


def apply_cpu_affinity_from_env() -> Optional[set]:
    """Pin this process to ``FMRP_PROC_CPUS`` ("0-3" or "4,5,6") before
    torch starts its thread pools, which size themselves from the
    schedulable CPUs. Unset = no pinning. Returns the applied set, or
    None."""
    spec = os.environ.get("FMRP_PROC_CPUS", "").strip()
    if not spec or not hasattr(os, "sched_setaffinity"):
        return None
    cpus: set = set()
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            cpus.update(range(int(lo), int(hi) + 1))
        elif part:
            cpus.add(int(part))
    if not cpus:
        return None
    os.sched_setaffinity(0, cpus)
    return cpus


def run_rounds(handler: Callable[[dict], Optional[dict]]) -> None:
    """Worker-side job loop over the exchange: rank 0 broadcasts job
    dicts; ``handler(job)`` runs each one; a ``{"op": "stop"}`` job ends
    the loop."""
    ex = host_exchange()
    if ex is None:
        raise DistributedError("run_rounds needs an initialized exchange")
    while True:
        job = ex.broadcast_obj(None, root=0)
        if not isinstance(job, dict) or job.get("op") == "stop":
            return
        handler(job)
