"""Distributed observability: trace propagation, metric aggregation, and
flight annexes that survive SIGKILL.

The telemetry layer (spans, registry, exporters) is process-local; this
module makes N processes observable as one system:

- **Trace context propagation.** :func:`trace_env` puts ``FMRP_TRACE_*``
  into every spawned child's environment (fleet replicas, grid workers)
  and :func:`install_remote_context_from_env` installs it child-side, so
  a child's root spans carry ``remote_trace``/``remote_parent`` attrs
  naming the span that spawned them. Per-request parenting rides the
  data plane: the shm frame header and the socket messages carry
  ``(t_send_ns, trace_id, parent_span)`` stamps
  (``serving.shm.frame_meta``).

- **Clock alignment.** ``time.perf_counter_ns()`` on Linux is
  ``CLOCK_MONOTONIC``, shared by every process on the host, so raw
  stamps compare across processes. Each process keeps its own epoch
  anchor (``spans.EPOCH_ANCHOR_NS``); children report theirs in the hello
  handshake (:func:`register_peer` records it) and every export writes
  it into its meta, so the timeline merge (``telemetry.timeline``)
  re-anchors every process onto the router's exactly.

- **Metric aggregation.** Children ship delta-encoded registry snapshots
  (:func:`registry_delta`) on the stats heartbeat; the fleet folds them
  into a :class:`MetricAggregator` keyed by a ``{proc=}`` label. When a
  proc departs, its monotone series (``_total``/``_count``/``_sum``/
  ``_bucket``) fold into a ``proc="departed"`` accumulator, so fleet
  totals never move backwards across a kill and respawn. Mutation and
  every whole-registry snapshot share ``metrics.SNAPSHOT_LOCK``.

- **Flight annex.** A small double-buffered shm segment per fleet member
  (:class:`FlightAnnex`). The child mirrors its flight-recorder tail into
  the inactive slot and flips the ``active`` word last (the ring
  protocol's commit-last rule), so whenever SIGKILL lands, the parent
  harvests a complete previous mirror.

Imports of ``parallel.shm`` and ``resilience.faults`` are lazy:
``parallel.shm`` imports telemetry for its transport instruments.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

from fm_returnprediction_tpu_torch.telemetry import export as _export
from fm_returnprediction_tpu_torch.telemetry import metrics as _metrics
from fm_returnprediction_tpu_torch.telemetry import spans as _spans

__all__ = [
    "trace_env",
    "install_remote_context_from_env",
    "register_peer",
    "peers",
    "clear_peers",
    "dump_peers",
    "registry_delta",
    "reset_delta_state",
    "metrics_enabled",
    "MetricAggregator",
    "FlightAnnex",
    "annex_enabled",
    "annex_bytes",
    "ANNEX_MIRROR_SITE",
]

_TRUE = ("1", "on", "true", "yes")
_FALSE = ("0", "off", "false", "no")


# ---------------------------------------------------------------------------
# trace context propagation
# ---------------------------------------------------------------------------


def trace_env(base: Optional[dict] = None) -> dict:
    """The ``FMRP_TRACE_*`` block for a spawned child's environment:
    telemetry arming + trace dir passthrough, plus the current span's
    ``(trace_id, span_id)`` as ``FMRP_TRACE_REMOTE`` so the child's root
    spans parent onto the router span doing the spawning. Updates and
    returns ``base`` when given; empty when telemetry is unarmed."""
    env: Dict[str, str] = {}
    for key in ("FMRP_TELEMETRY", "FMRP_TRACE_DIR"):
        val = os.environ.get(key)
        if val:
            env[key] = val
    if _spans.active():
        cur = _spans.current_span()
        if cur is not None:
            env["FMRP_TRACE_REMOTE"] = f"{cur.trace_id}:{cur.span_id}"
    if base is not None:
        base.update(env)
        return base
    return env


def install_remote_context_from_env(env=None) -> Optional[Tuple[int, int]]:
    """Child-side: parse ``FMRP_TRACE_REMOTE`` and install it as the
    remote span context (``spans.set_remote_context``). Returns the
    ``(trace_id, span_id)`` installed, or ``None``."""
    env = os.environ if env is None else env
    raw = env.get("FMRP_TRACE_REMOTE", "")
    if not raw:
        return None
    try:
        trace_id, _, span_id = raw.partition(":")
        ctx = (int(trace_id), int(span_id or 0))
    except ValueError:
        return None
    _spans.set_remote_context(*ctx)
    return ctx


# ---------------------------------------------------------------------------
# peer registry (router-side): who is out there, and on what clock
# ---------------------------------------------------------------------------

_PEERS: Dict[str, dict] = {}
_PEER_LOCK = threading.Lock()


def register_peer(ident, *, pid: Optional[int] = None,
                  anchor_ns: Optional[int] = None,
                  kind: str = "replica") -> dict:
    """Record a child process's identity and epoch anchor (shipped in
    its hello). ``offset_ns`` is the child's anchor minus OURS — the
    exact correction the timeline merge applies, kept here as harvested
    evidence that the clocks were exchanged."""
    entry = {
        "ident": str(ident),
        "kind": kind,
        "pid": None if pid is None else int(pid),
        "anchor_ns": None if anchor_ns is None else int(anchor_ns),
        "offset_ns": (
            None if anchor_ns is None
            else int(anchor_ns) - _spans.EPOCH_ANCHOR_NS
        ),
    }
    with _PEER_LOCK:
        _PEERS[str(ident)] = entry
    return entry


def peers() -> Dict[str, dict]:
    with _PEER_LOCK:
        return {k: dict(v) for k, v in _PEERS.items()}


def clear_peers() -> None:
    with _PEER_LOCK:
        _PEERS.clear()


def dump_peers(trace_dir) -> Path:
    """Write the peer registry as ``peers.json`` beside the trace
    exports (atomic; the timeline CLI reads it when present)."""
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "peers.json"
    doc = {
        "router_pid": os.getpid(),
        "router_anchor_ns": _spans.EPOCH_ANCHOR_NS,
        "peers": peers(),
    }
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    tmp.write_text(json.dumps(doc, sort_keys=True, indent=1))
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# metric aggregation: child deltas → one scrape endpoint
# ---------------------------------------------------------------------------


def metrics_enabled() -> bool:
    """Child→router metric shipping knob (``FMRP_OBS_METRICS``, default
    on)."""
    return os.environ.get("FMRP_OBS_METRICS", "1").strip().lower() \
        not in _FALSE


def _numeric_flat() -> Dict[str, float]:
    """The registry as flat numeric series: histogram dict values
    explode into ``_sum``/``_count`` (bucket vectors stay process-local
    — edges aren't carried in the flat key), bools become 0/1, NaN and
    non-numerics drop."""
    flat: Dict[str, float] = {}
    for key, value in _export.flat_metrics().items():
        if isinstance(value, dict):
            name, sep, rest = key.partition("{")
            suffix = f"{{{rest}" if sep else ""
            count = value.get("count")
            total = value.get("sum")
            if isinstance(count, (int, float)):
                flat[f"{name}_count{suffix}"] = count
            if isinstance(total, (int, float)):
                flat[f"{name}_sum{suffix}"] = total
        elif isinstance(value, bool):
            flat[key] = int(value)
        elif isinstance(value, (int, float)) and value == value:
            flat[key] = value
    return flat


_DELTA_LOCK = threading.Lock()
_LAST_SHIPPED: Dict[str, float] = {}


def registry_delta() -> Dict[str, float]:
    """Child-side: the numeric registry series that changed since the
    last call — the delta-encoded payload the stats heartbeat ships.
    First call ships everything."""
    with _DELTA_LOCK:
        flat = _numeric_flat()
        delta = {
            k: v for k, v in flat.items() if _LAST_SHIPPED.get(k) != v
        }
        _LAST_SHIPPED.update(delta)
        return delta


def reset_delta_state() -> None:
    with _DELTA_LOCK:
        _LAST_SHIPPED.clear()


#: suffixes that mark a series monotone (fold-on-death candidates) —
#: the same rule the fleet stats fold uses for its agg_* counters
_MONOTONE_SUFFIXES = ("_total", "_count", "_sum", "_bucket")


def _with_proc(key: str, proc: str) -> str:
    name, sep, rest = key.partition("{")
    labels = rest[:-1] if sep else ""
    merged = f"{labels},proc={proc}" if labels else f"proc={proc}"
    return f"{name}{{{merged}}}"


class MetricAggregator:
    """Router-side fold of child registry deltas into one exposition.

    ``ingest(proc, delta)`` accumulates the latest value per series per
    live proc; ``fold_dead(proc)`` retires a proc, folding its monotone
    series into a ``proc="departed"`` accumulator so fleet totals never
    move backwards across a kill/respawn (the replacement respawns
    under a NEW proc label and counts up from zero). Every mutation and
    read holds ``metrics.SNAPSHOT_LOCK`` — the same lock the registry
    flatten and the Prometheus render take — so one snapshot is one
    consistent instant."""

    def __init__(self) -> None:
        self._live: Dict[str, Dict[str, float]] = {}
        self._departed: Dict[str, float] = {}

    def ingest(self, proc, delta: Optional[dict]) -> int:
        if not delta:
            return 0
        with _metrics.SNAPSHOT_LOCK:
            bucket = self._live.setdefault(str(proc), {})
            n = 0
            for key, value in delta.items():
                if isinstance(value, bool):
                    value = int(value)
                if not isinstance(value, (int, float)) or value != value:
                    continue
                bucket[str(key)] = value
                n += 1
            return n

    def fold_dead(self, proc) -> None:
        with _metrics.SNAPSHOT_LOCK:
            last = self._live.pop(str(proc), None)
            if not last:
                return
            for key, value in last.items():
                name = key.partition("{")[0]
                if name.endswith(_MONOTONE_SUFFIXES):
                    self._departed[key] = self._departed.get(key, 0) + value

    def procs(self) -> Tuple[str, ...]:
        with _metrics.SNAPSHOT_LOCK:
            return tuple(sorted(self._live))

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name{...,proc=K} → value`` across live procs plus the
        ``proc=departed`` fold — one consistent instant under the
        snapshot lock."""
        with _metrics.SNAPSHOT_LOCK:
            out: Dict[str, float] = {}
            for proc in sorted(self._live):
                for key, value in sorted(self._live[proc].items()):
                    out[_with_proc(key, proc)] = value
            for key, value in sorted(self._departed.items()):
                out[_with_proc(key, "departed")] = value
            return out

    def totals(self) -> Dict[str, float]:
        """Monotone series summed across live procs + the departed fold
        — the "fleet totals" the monotonicity acceptance watches."""
        with _metrics.SNAPSHOT_LOCK:
            out: Dict[str, float] = {}
            sources = list(self._live.values()) + [self._departed]
            for bucket in sources:
                for key, value in bucket.items():
                    name = key.partition("{")[0]
                    if name.endswith(_MONOTONE_SUFFIXES):
                        out[key] = out.get(key, 0) + value
            return out

    def prometheus_text(self) -> str:
        """The aggregated child series as exposition lines (untyped —
        the router's own registry already declares TYPE for its local
        twins of these names; proc labels keep the series distinct)."""
        lines = []
        for key, value in sorted(self.snapshot().items()):
            name, sep, rest = key.partition("{")
            labels = rest[:-1] if sep else ""
            parts = []
            for item in labels.split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                parts.append(
                    f'{_metrics.sanitize(k)}='
                    f'"{_metrics.escape_label_value(v)}"'
                )
            rendered = f"{{{','.join(parts)}}}" if parts else ""
            lines.append(f"{_metrics.sanitize(name)}{rendered} {value}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# flight annex: the tail that survives SIGKILL
# ---------------------------------------------------------------------------

#: chaos site between the payload write and the commit flip — a SIGKILL
#: injected here MUST leave the previous mirror harvestable
ANNEX_MIRROR_SITE = "obs.annex_mirror"

_ANNEX_MAGIC = 0x464D4F41  # "FMOA"
#: magic, slot_bytes, len0, len1, active (0/1 valid, other = none);
#: ``active`` is the LAST word a mirror writes — commit-last, like the
#: ring protocol, so a torn mirror is absent, never partial
_ANNEX_HDR = struct.Struct("<IIIII")
_ANNEX_NONE = 0xFFFFFFFF


def annex_enabled() -> bool:
    """Whether fleet members get a flight annex: ``FMRP_OBS_ANNEX``
    forces on/off; unset defaults to armed-telemetry-only so the
    unarmed hot path never pays for mirrors."""
    raw = os.environ.get("FMRP_OBS_ANNEX", "").strip().lower()
    if raw in _FALSE:
        return False
    if raw in _TRUE:
        return True
    return _spans.active()


def annex_bytes() -> int:
    try:
        n = int(os.environ.get("FMRP_OBS_ANNEX_BYTES", "16384"))
    except ValueError:
        n = 16384
    return max(1024, n)


class FlightAnnex:
    """A per-member double-buffered shm mailbox for flight-recorder
    tails. The parent creates and owns it (ledgered for
    ``parallel.shm.sweep_segments``); the child attaches and mirrors; the parent harvests after
    death — including death by SIGKILL, which skips atexit and takes
    the child's in-memory collector with it."""

    def __init__(self, seg, slot_bytes: int, owner: bool) -> None:
        self._seg = seg
        self.slot_bytes = int(slot_bytes)
        self.owner = owner
        self.name = seg.name

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, ident: str, nbytes: Optional[int] = None
               ) -> "FlightAnnex":
        from multiprocessing import shared_memory

        from fm_returnprediction_tpu_torch.parallel import shm as _pshm

        slot = (nbytes if nbytes is not None else annex_bytes())
        size = _ANNEX_HDR.size + 2 * slot
        safe = "".join(c if c.isalnum() else "-" for c in str(ident))
        name = f"fmrp-annex-{safe}-{os.getpid()}-{os.urandom(3).hex()}"
        seg = shared_memory.SharedMemory(name=name, create=True, size=size)
        _ANNEX_HDR.pack_into(
            seg.buf, 0, _ANNEX_MAGIC, slot, 0, 0, _ANNEX_NONE
        )
        _pshm._ledger_add(seg.name)
        return cls(seg, slot, owner=True)

    def describe(self) -> dict:
        return {"name": self.name, "slot_bytes": self.slot_bytes}

    @classmethod
    def attach(cls, spec: dict) -> "FlightAnnex":
        from multiprocessing import shared_memory

        from fm_returnprediction_tpu_torch.parallel import shm as _pshm

        seg = shared_memory.SharedMemory(name=spec["name"])
        _pshm._unregister(seg.name)  # attacher must not unlink (bpo-38119)
        magic = _ANNEX_HDR.unpack_from(seg.buf, 0)[0]
        if magic != _ANNEX_MAGIC:
            seg.close()
            raise ValueError(f"not a flight annex: {spec['name']}")
        return cls(seg, int(spec["slot_bytes"]), owner=False)

    def close(self) -> None:
        try:
            self._seg.close()
        except (OSError, BufferError):
            pass

    def release(self) -> None:
        """Owner-side disposal through the shared ledger teardown."""
        if not self.owner:
            self.close()
            return
        from fm_returnprediction_tpu_torch.parallel import shm as _pshm

        _pshm.release_segment(self._seg)

    # -- child side --------------------------------------------------------

    def mirror(self, payload: dict) -> bool:
        """Write ``payload`` into the inactive slot, then commit.
        Returns False (previous mirror untouched) when the payload
        doesn't fit. The chaos site fires BETWEEN payload write and
        commit — SIGKILL there must leave the previous mirror whole."""
        data = json.dumps(payload, sort_keys=True).encode()
        if len(data) > self.slot_bytes:
            return False
        buf = self._seg.buf
        active = _ANNEX_HDR.unpack_from(buf, 0)[4]
        target = 1 - active if active in (0, 1) else 0
        off = _ANNEX_HDR.size + target * self.slot_bytes
        buf[off:off + len(data)] = data
        struct.pack_into("<I", buf, 8 + 4 * target, len(data))
        try:
            from fm_returnprediction_tpu_torch.resilience.faults import fault_site

            fault_site(ANNEX_MIRROR_SITE, payload=target)
        except ImportError:  # pragma: no cover - resilience always present
            pass
        struct.pack_into("<I", buf, 16, target)  # commit LAST
        return True

    def mirror_flight(self, reason: str, max_spans: int = 32) -> bool:
        """Mirror a compact flight snapshot, shedding weight until it
        fits the slot (full → no metrics → last-8 spans → vitals)."""
        from fm_returnprediction_tpu_torch.telemetry import perf as _perf

        snap = _perf.flight_snapshot(reason, max_spans=max_spans)
        candidates = (
            snap,
            {**snap, "metrics": {}},
            {**snap, "metrics": {}, "spans": snap.get("spans", [])[-8:],
             "events": snap.get("events", [])[-8:]},
            {"type": "flight", "schema": snap.get("schema", 1),
             "reason": reason, "pid": os.getpid()},
        )
        for candidate in candidates:
            if self.mirror(candidate):
                return True
        return False

    # -- parent side -------------------------------------------------------

    def harvest(self) -> Optional[dict]:
        """Read the committed slot; None when no complete mirror exists
        (never raises on garbage — a half-written annex reads as
        absent)."""
        try:
            buf = self._seg.buf
            _, slot, len0, len1, active = _ANNEX_HDR.unpack_from(buf, 0)
        except (ValueError, struct.error):
            return None
        if active not in (0, 1):
            return None
        ln = (len0, len1)[active]
        if not 0 < ln <= self.slot_bytes:
            return None
        off = _ANNEX_HDR.size + active * self.slot_bytes
        try:
            return json.loads(bytes(buf[off:off + ln]).decode())
        except (ValueError, UnicodeDecodeError):
            return None
