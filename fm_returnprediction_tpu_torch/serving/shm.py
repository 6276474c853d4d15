"""The process fleet's shared-memory data plane (``FMRP_FLEET_TRANSPORT=shm``).

Process replicas talk to the router over the length-prefixed pickle socket
(``serving.replica_proc``), where every query pays a pickle and two socket
round trips, one row at a time. This module moves the data plane (submit
→ accept/reject → result) onto a pair of ``parallel.shm.ShmRing`` rings
with fixed-width binary frames; the control plane (hello, stats, drain,
prepare/commit, close) stays on the socket:

- the front end coalesces: every submit lands in a pending strip and the
  first caller through the flush lock packs all pending rows into one
  frame (occupancy in ``fmrp_transport_batch_rows``);
- admission is optimistic: the router enforces the replica batcher's
  ``max_queue`` ceiling itself and skips the per-row accept round trip; a
  replica-side disagreement comes back as an ACK frame carrying only the
  rejected rows, delivered on the request's future;
- the replica streams RESULT frames as its futures resolve, values plus
  ``DegradedQuote`` disclosure columns (route/precision/m/err_bound), so a
  disclosure-carrying float crosses the boundary intact;
- ring-full is typed backpressure: a writer stalled past its deadline
  raises ``ServiceOverloadError(reason="transport_ring_full")``;
- torn frames read as absent (the ring's commit-last protocol), so a
  ``hard_crash`` mid-send leaves nothing half-read and the journal's
  recovery path closes the admitted request out.

Frame grammar, byte for byte the reference package's (all little-endian,
one frame per ring slot; every header also carries the observability
stamps ``u64 t_send_ns · u64 trace_id · u64 parent_span``, zeros when
telemetry is unarmed, read by :func:`frame_meta`):

==========  =================================================================
``SUBMIT``  u32 kind=1 · u32 count · u64 tail_len · ids u64[c] ·
            months i64[c] · widths u32[c] · dcodes u8[c] · row payload
            (concatenated raw row bytes) · [pickle tail: non-int months /
            non-f32/f64 rows]
``ACK``     u32 kind=2 · u32 count · u64 tail_len · ids u64[c] ·
            status u8[c] (0 ok · 1 queue_full · 2 closed · 3 error) ·
            [pickle tail: per-reject evidence]
``RESULT``  u32 kind=3 · u32 count · u64 tail_len · ids u64[c] ·
            ok u8[c] · values f64[c] · degraded u8[c] · m i64[c] ·
            err f64[c] · route u8[c] · prec u8[c] · [pickle tail:
            exception blobs / out-of-table route strings]
==========  =================================================================

The pickle tails carry the cold paths only (rejects, failures, exotic
dtypes); a strip of f32 rows and int months crosses with zero pickle.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from fm_returnprediction_tpu_torch.parallel.shm import RingFullError, ShmRing
from fm_returnprediction_tpu_torch.resilience.errors import ServiceOverloadError
from fm_returnprediction_tpu_torch.resilience.faults import fault_site
from fm_returnprediction_tpu_torch.telemetry import spans as _spans

__all__ = [
    "FLEET_TRANSPORTS",
    "ShmReplicaChannel",
    "frame_meta",
    "open_doorbells",
    "pack_ack",
    "pack_results",
    "pack_submit",
    "resolve_fleet_transport",
    "serve_data_plane",
    "sweep_doorbells",
    "unpack_frame",
]

FLEET_TRANSPORTS = ("shm", "socket")

KIND_SUBMIT, KIND_ACK, KIND_RESULT = 1, 2, 3
#: kind, count, tail_len, t_send_ns, trace_id, parent_span — the last
#: three are the distributed-observability stamps: the sender's
#: monotonic send time (CLOCK_MONOTONIC is box-wide, so the receiver
#: reads transport latency directly) and the sending span's identity so
#: child work parents onto the router's request trace. All three are
#: zero when telemetry is unarmed — the observability plane costs one
#: constant-fold struct pack on the unarmed hot path.
_FRAME_HDR = struct.Struct("<IIQQQQ")


def _hdr(kind: int, count: int, tail_len: int) -> bytes:
    if _spans.active():
        cur = _spans.current_span()
        return _FRAME_HDR.pack(
            kind, count, tail_len, time.perf_counter_ns(),
            cur.trace_id if cur is not None else 0,
            cur.span_id if cur is not None else 0,
        )
    return _FRAME_HDR.pack(kind, count, tail_len, 0, 0, 0)


def frame_meta(frame: bytes) -> dict:
    """The header's observability stamps (all zero on frames packed
    while telemetry was unarmed). ``unpack_frame`` deliberately does
    NOT return these — decoding rows and reading stamps are different
    consumers."""
    kind, count, _, t_send_ns, trace_id, parent_span = \
        _FRAME_HDR.unpack_from(frame, 0)
    return {"kind": kind, "count": count, "t_send_ns": t_send_ns,
            "trace_id": trace_id, "parent_span": parent_span}

# row dtype codes (dcodes column)
_DT_F32, _DT_F64, _DT_PICKLED = 0, 1, 2
_F32, _F64 = np.dtype(np.float32), np.dtype(np.float64)
# DegradedQuote route/precision code tables (0 = absent / plain float)
_ROUTE_CODES = {None: 0, "bf16": 1, "coreset": 2}
_ROUTE_NAMES = {v: k for k, v in _ROUTE_CODES.items()}
_PREC_CODES = {None: 0, "f32": 1, "bf16": 2}
_PREC_NAMES = {v: k for k, v in _PREC_CODES.items()}
_CODE_OTHER = 3  # string rides the pickle tail

STATUS_OK, STATUS_QUEUE_FULL, STATUS_CLOSED, STATUS_ERROR = 0, 1, 2, 3

# a pickled exception riding a frame tail must stay a small fraction of
# the slot: past this the blob is dropped and the (already truncated)
# repr travels alone — the parent re-raises a RuntimeError from it
_MAX_EXC_BLOB = 8192


def _bounded_exc_blob(exc) -> Optional[bytes]:
    try:
        blob = pickle.dumps(exc)
    except Exception:  # noqa: BLE001 — unpicklable: repr travels
        return None
    return blob if len(blob) <= _MAX_EXC_BLOB else None


def resolve_fleet_transport(transport: Optional[str] = None) -> str:
    """The fleet's process-replica data plane: explicit argument >
    ``FMRP_FLEET_TRANSPORT`` > ``auto`` (= shm where POSIX shared
    memory works and one replica's two rings fit ``/dev/shm``, else the
    socket). The socket is always a legal choice: it is the oracle the
    shm path is held against."""
    if transport is None:
        transport = os.environ.get(
            "FMRP_FLEET_TRANSPORT", ""
        ).strip().lower() or "auto"
    if transport in FLEET_TRANSPORTS:
        return transport
    if transport != "auto":
        raise ValueError(
            f"fleet transport must be one of {('auto',) + FLEET_TRANSPORTS},"
            f" got {transport!r}"
        )
    from fm_returnprediction_tpu_torch.parallel.shm import HEADER_BYTES, shm_available

    slots = int(os.environ.get("FMRP_FLEET_SHM_SLOTS", "64"))
    slot_bytes = int(os.environ.get("FMRP_FLEET_SHM_SLOT_BYTES", str(64 * 1024)))
    return "shm" if shm_available(2 * (HEADER_BYTES + slots * slot_bytes)) else "socket"


# -- frame packing ------------------------------------------------------------


def pack_submit(rows: Sequence[Tuple[int, object, object]]) -> bytes:
    """``rows`` = [(req_id, month, x), ...] → one SUBMIT frame. Int-like
    months ride the i64 column; anything else (timestamps, labels) falls
    back to the pickle tail. 1-D f32/f64 rows ride the strip raw-byte
    for-byte (bit-identical reconstruction); anything else is pickled.
    The steady state — int months, same-dtype float rows — packs with
    vectorized column builds, no per-row numpy scalar stores; a single
    row (the blocking-caller shape) takes a struct-only fast path."""
    c = len(rows)

    def _int_month(m) -> bool:
        return isinstance(m, (int, np.integer)) and not isinstance(m, bool)

    if c == 1:
        rid, month, x = rows[0]
        dt = getattr(x, "dtype", None)
        if _int_month(month) and dt is not None and (
                dt == _F32 or dt == _F64) and x.ndim == 1:
            code = _DT_F32 if dt == _F32 else _DT_F64
            body = struct.pack("<QqIB", rid, int(month), x.shape[0],
                               code) + x.tobytes()
            return _hdr(KIND_SUBMIT, 1, 0) + body
    ids = np.fromiter((r[0] for r in rows), np.uint64, c)
    # the i64 column is for REAL ints only — np.fromiter would silently
    # truncate a float month (7.5 → 7: a wrong-month quote where the
    # socket oracle raises), so anything non-int rides the pickle tail
    # and meets the service's own month_index validation child-side
    if all(_int_month(r[1]) for r in rows):
        months = np.fromiter((r[1] for r in rows), np.int64, c)
        tail_months: Optional[list] = None
    else:
        months = np.zeros(c, np.int64)
        tail_months = [None] * c
        for i, (_, month, _) in enumerate(rows):
            if _int_month(month):
                months[i] = int(month)
            else:
                tail_months[i] = month
    widths = np.zeros(c, np.uint32)
    dcodes = np.zeros(c, np.uint8)
    payload: List[bytes] = []
    tail_rows: dict = {}
    for i, (_, _, x) in enumerate(rows):
        # NB: dt must be a real dtype before comparing — numpy treats
        # ``None == dtype('float64')`` as TRUE (dtype(None) is f64)
        dt = getattr(x, "dtype", None)
        if dt is not None and dt == _F32 and x.ndim == 1:
            dcodes[i] = _DT_F32
        elif dt is not None and dt == _F64 and x.ndim == 1:
            dcodes[i] = _DT_F64
        else:
            dcodes[i] = _DT_PICKLED
            tail_rows[i] = x
            continue
        widths[i] = x.shape[0]
        payload.append(x.tobytes())
    tail = b""
    if tail_months is not None or tail_rows:
        tail = pickle.dumps({"months": tail_months, "rows": tail_rows})
    body = b"".join((
        ids.tobytes(), months.tobytes(), widths.tobytes(), dcodes.tobytes(),
        *payload, tail,
    ))
    return _hdr(KIND_SUBMIT, c, len(tail)) + body


def pack_ack(ids: Sequence[int], statuses: Sequence[int],
             evidence: Optional[dict] = None) -> bytes:
    """ACK frame: per-row accept/reject statuses; ``evidence`` maps row
    position → reject payload dict (queue evidence / pickled exception),
    present only when something was rejected."""
    c = len(ids)
    ids_a = np.asarray(ids, np.uint64)
    st = np.asarray(statuses, np.uint8)
    tail = pickle.dumps(evidence) if evidence else b""
    return (_hdr(KIND_ACK, c, len(tail))
            + ids_a.tobytes() + st.tobytes() + tail)


def pack_results(entries: Sequence[Tuple[int, bool, object]]) -> bytes:
    """``entries`` = [(req_id, ok, value_or_exc), ...] → one RESULT
    frame. A ``DegradedQuote`` value's disclosure fields travel as
    columns; a failure's exception pickles into the tail."""
    c = len(entries)
    ids = np.empty(c, np.uint64)
    oks = np.zeros(c, np.uint8)
    values = np.full(c, np.nan, np.float64)
    degraded = np.zeros(c, np.uint8)
    ms = np.full(c, -1, np.int64)
    errs = np.full(c, np.nan, np.float64)
    routes = np.zeros(c, np.uint8)
    precs = np.zeros(c, np.uint8)
    tail_map: dict = {}
    for i, (rid, ok, val) in enumerate(entries):
        ids[i] = rid
        if not ok:
            tail_map[i] = {"exc": _bounded_exc_blob(val),
                           "error": repr(val)[:300]}
            continue
        oks[i] = 1
        values[i] = float(val)
        route = getattr(val, "route", None)
        if route is None:
            continue
        degraded[i] = 1
        routes[i] = _ROUTE_CODES.get(route, _CODE_OTHER)
        prec = getattr(val, "precision", None)
        precs[i] = _PREC_CODES.get(prec, _CODE_OTHER)
        if routes[i] == _CODE_OTHER or precs[i] == _CODE_OTHER:
            tail_map[i] = {"route": route, "precision": prec}
        m = getattr(val, "m", None)
        if m is not None:
            ms[i] = int(m)
        err = getattr(val, "err_bound", None)
        if err is not None:
            errs[i] = float(err)
    tail = pickle.dumps(tail_map) if tail_map else b""
    body = b"".join((
        ids.tobytes(), oks.tobytes(), values.tobytes(), degraded.tobytes(),
        ms.tobytes(), errs.tobytes(), routes.tobytes(), precs.tobytes(),
        tail,
    ))
    return _hdr(KIND_RESULT, c, len(tail)) + body


def unpack_frame(frame: bytes):
    """→ ``(kind, rows)``; rows decode per the frame grammar above.
    The header's observability stamps are skipped — ``frame_meta``
    reads those."""
    kind, c, tail_len = _FRAME_HDR.unpack_from(frame, 0)[:3]
    off = _FRAME_HDR.size
    tail = pickle.loads(frame[len(frame) - tail_len:]) if tail_len else None
    if kind == KIND_SUBMIT:
        ids = np.frombuffer(frame, np.uint64, c, off); off += 8 * c
        months = np.frombuffer(frame, np.int64, c, off); off += 8 * c
        widths = np.frombuffer(frame, np.uint32, c, off); off += 4 * c
        dcodes = np.frombuffer(frame, np.uint8, c, off); off += c
        rows = []
        t_months = (tail or {}).get("months") if tail else None
        t_rows = (tail or {}).get("rows") if tail else {}
        for i in range(c):
            month = (t_months[i] if t_months is not None
                     and t_months[i] is not None else int(months[i]))
            if dcodes[i] == _DT_PICKLED:
                rows.append((int(ids[i]), month, t_rows[i]))
                continue
            dt = np.float32 if dcodes[i] == _DT_F32 else np.float64
            w = int(widths[i])
            nbytes = w * np.dtype(dt).itemsize
            x = np.frombuffer(frame, dt, w, off).copy()
            off += nbytes
            rows.append((int(ids[i]), month, x))
        return kind, rows
    if kind == KIND_ACK:
        ids = np.frombuffer(frame, np.uint64, c, off); off += 8 * c
        st = np.frombuffer(frame, np.uint8, c, off)
        evidence = tail or {}
        return kind, [(int(ids[i]), int(st[i]), evidence.get(i))
                      for i in range(c)]
    if kind == KIND_RESULT:
        ids = np.frombuffer(frame, np.uint64, c, off); off += 8 * c
        oks = np.frombuffer(frame, np.uint8, c, off); off += c
        values = np.frombuffer(frame, np.float64, c, off); off += 8 * c
        deg = np.frombuffer(frame, np.uint8, c, off); off += c
        ms = np.frombuffer(frame, np.int64, c, off); off += 8 * c
        errs = np.frombuffer(frame, np.float64, c, off); off += 8 * c
        routes = np.frombuffer(frame, np.uint8, c, off); off += c
        precs = np.frombuffer(frame, np.uint8, c, off); off += c
        tail_map = tail or {}
        if not tail_map and not deg.any() and oks.all():
            # steady state: every row a plain successful float — build
            # the batch with two tolist()s, no per-row numpy reads
            return kind, [(i, True, v)
                          for i, v in zip(ids.tolist(), values.tolist())]
        out = []
        for i in range(c):
            extra = tail_map.get(i)
            if not oks[i]:
                out.append((int(ids[i]), False, extra or {}))
                continue
            value: object = float(values[i])
            if deg[i]:
                from fm_returnprediction_tpu_torch.serving.brownout import (
                    DegradedQuote,
                )

                route = (extra.get("route") if extra and "route" in extra
                         else _ROUTE_NAMES.get(int(routes[i])))
                prec = (extra.get("precision")
                        if extra and "precision" in extra
                        else _PREC_NAMES.get(int(precs[i])))
                value = DegradedQuote(
                    float(values[i]), route=route or "?",
                    precision=prec or "?",
                    m=int(ms[i]) if ms[i] >= 0 else None,
                    err_bound=(float(errs[i])
                               if np.isfinite(errs[i]) else None),
                )
            out.append((int(ids[i]), True, value))
        return kind, out
    raise ValueError(f"unknown frame kind {kind}")


# -- parent side: the coalescing channel --------------------------------------


# -- doorbell fd ledger (the fd half of the hygiene audit) --------------------
#
# Mirror of ``parallel.shm``'s owned-segment ledger: every eventfd this
# process creates is entered at creation and struck at close. Normal
# channel teardown strikes both bells; anything still listed after a
# crash path is a leaked fd that :func:`sweep_doorbells` closes and counts into
# ``fmrp_topology_leaked_fds_total``.

_BELL_LOCK = threading.Lock()
_BELLS: set = set()


def open_doorbells() -> Tuple[int, ...]:
    """Snapshot of doorbell fds this process created and has not yet
    closed — live channels plus any leaks-in-waiting."""
    with _BELL_LOCK:
        return tuple(sorted(_BELLS))


def sweep_doorbells() -> List[int]:
    """Close every still-ledgered doorbell fd and count the ones that
    were still open as leaks. Like ``parallel.shm.sweep_segments``: call
    after tearing down everything you own — a live channel's bells read
    as leaks here by design."""
    with _BELL_LOCK:
        fds = sorted(_BELLS)
        _BELLS.clear()
    leaked: List[int] = []
    for fd in fds:
        try:
            os.close(fd)
        except OSError:
            continue  # already closed without striking: not a leak
        leaked.append(fd)
    if leaked:
        from fm_returnprediction_tpu_torch import telemetry

        telemetry.registry().counter(
            "fmrp_topology_leaked_fds_total",
            help="doorbell eventfds still open when the topology sweep ran",
        ).inc(len(leaked))
    return leaked


def _make_doorbell() -> Optional[int]:
    """One eventfd doorbell (Linux; None elsewhere → the rings fall
    back to sleep-polling). Created inheritable-on-request: the spawn
    passes it via ``pass_fds`` so the child sees the same fd number.

    ``serving.shm.doorbell_fd`` is the doorbell-loss chaos site: an
    injected OSError here is exactly what fd exhaustion looks like, and
    the channel must degrade to the poll fallback (correct quotes,
    higher latency), never fail."""
    if not hasattr(os, "eventfd"):
        return None
    try:
        fault_site("serving.shm.doorbell_fd")
        fd = os.eventfd(0)
    except OSError:
        return None
    with _BELL_LOCK:
        _BELLS.add(fd)
    return fd


class ShmReplicaChannel:
    """The router's end of one replica's shm data plane.

    ``submit_row`` appends to a pending strip and then COMBINES: the
    first caller to take the flush lock packs everything pending into
    one frame — callers landing while a frame is being written ride the
    next one (the micro-batcher's adaptive coalescing, one layer down,
    with no dedicated writer thread and no wakeup hop on the submit
    path). A reader thread dispatches ACK/RESULT frames back into the
    replica handle's pending map. Owns both rings and both doorbells
    (creator side)."""

    def __init__(self, *, on_ack: Callable, on_results: Callable,
                 on_dead: Callable, replica_id: str = "",
                 slots: Optional[int] = None,
                 slot_bytes: Optional[int] = None,
                 send_timeout_s: Optional[float] = None,
                 instruments: Optional[dict] = None):
        from fm_returnprediction_tpu_torch.parallel.shm import (
            transport_instruments,
        )

        slots = int(slots or os.environ.get("FMRP_FLEET_SHM_SLOTS", "64"))
        slot_bytes = int(
            slot_bytes or os.environ.get("FMRP_FLEET_SHM_SLOT_BYTES",
                                         str(64 * 1024))
        )
        self._send_timeout_s = float(
            send_timeout_s
            if send_timeout_s is not None
            else os.environ.get("FMRP_FLEET_SHM_SEND_TIMEOUT_S", "5.0")
        )
        self._inst = (instruments if instruments is not None
                      else transport_instruments("shm", replica_id))
        self._req_bell = _make_doorbell()
        self._resp_bell = _make_doorbell()
        self.req_ring = ShmRing(create=True, slots=slots,
                                slot_bytes=slot_bytes,
                                instruments=self._inst,
                                doorbell_fd=self._req_bell)
        self.resp_ring = ShmRing(create=True, slots=slots,
                                 slot_bytes=slot_bytes,
                                 instruments=self._inst,
                                 doorbell_fd=self._resp_bell)
        self._on_ack = on_ack
        self._on_results = on_results
        self._on_dead = on_dead
        self._pending: deque = deque()
        self._plock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._stop = False
        # frames are bounded by BYTES, not a fixed row count: the drain
        # below accumulates rows until the slot's payload budget (minus
        # slack for the pickle tail cold paths) is spent, so a strip of
        # arbitrarily fat rows still fits its slot
        self._byte_budget = max(256, self.req_ring.payload_capacity - 4096)
        self._max_rows = 256
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"fmrp-shm-r-{replica_id}",
        )
        self._reader.start()

    def describe(self) -> dict:
        """The spawn-config stanza the child attaches from (ring names +
        inherited doorbell fd numbers)."""
        return {"req": self.req_ring.name, "resp": self.resp_ring.name,
                "req_bell": self._req_bell, "resp_bell": self._resp_bell}

    def pass_fds(self) -> Tuple[int, ...]:
        return tuple(fd for fd in (self._req_bell, self._resp_bell)
                     if fd is not None)

    def submit_row(self, req_id: int, month, x) -> None:
        # hop.coalesce: row enqueued → its frame on the ring (the
        # combining wait plus the ring write, measured per row)
        t0 = time.perf_counter_ns() if _spans.active() else 0
        with self._plock:
            if self._stop:
                raise RuntimeError("shm channel is stopped")
            self._pending.append((req_id, month, x))
        self._flush()
        if t0:
            _spans.record_span("hop.coalesce", t0, req=req_id)

    def _take_batch(self) -> List[Tuple[int, object, object]]:
        """Drain pending rows into one frame-sized batch, bounded by the
        slot's byte budget (21 B of columns + the row bytes per row), so
        a frame can only exceed its slot through the pathological single
        row / pickle-tail cases the send handler fails alone."""
        batch: List[Tuple[int, object, object]] = []
        spent = 0
        with self._plock:
            while self._pending and len(batch) < self._max_rows:
                row = self._pending[0]
                row_bytes = 21 + int(getattr(row[2], "nbytes", 64))
                if batch and spent + row_bytes > self._byte_budget:
                    break
                batch.append(self._pending.popleft())
                spent += row_bytes
        return batch

    def _flush(self) -> None:
        """Combining flush: drain-and-send until pending is empty. A
        caller that finds the lock held waits — the holder's drain loop
        will carry its row, or it drains whatever remains on acquire."""
        retry_single = False
        with self._flush_lock:
            while True:
                if retry_single:
                    retry_single = False
                    with self._plock:
                        batch = ([self._pending.popleft()]
                                 if self._pending else [])
                else:
                    batch = self._take_batch()
                if not batch:
                    return
                hist = self._inst.get("batch_rows")
                if hist is not None:
                    hist.observe(len(batch))
                try:
                    self.req_ring.send(pack_submit(batch),
                                       timeout_s=self._send_timeout_s)
                except RingFullError as exc:
                    # typed retriable backpressure: the transport itself
                    # is the saturated queue; the strip is refused the
                    # way a full batcher queue refuses, but with the
                    # fleet's 429 so callers back off instead of
                    # requeueing onto the same congested ring
                    overload = ServiceOverloadError(
                        f"replica shm request ring full: {exc}",
                        retry_after_s=self._send_timeout_s,
                        reason="transport_ring_full",
                    )
                    for rid, _, _ in batch:
                        self._on_ack(rid, STATUS_ERROR,
                                     {"overload": overload})
                except Exception as exc:  # noqa: BLE001 — pack OR send
                    # failure (over-capacity frame, an unpicklable row's
                    # TypeError out of pack_submit, ...): put everything
                    # back and retry the HEAD alone — only the genuinely
                    # poisonous single row fails, alone, with its error
                    # delivered (a batch-mate is never silently lost)
                    if len(batch) > 1:
                        with self._plock:
                            self._pending.extendleft(reversed(batch))
                        retry_single = True
                        continue
                    rid = batch[0][0]
                    self._on_ack(rid, STATUS_ERROR,
                                 {"exc": None, "error": repr(exc)[:300]})

    def _read_loop(self) -> None:
        try:
            while not self._stop:
                frame = self.resp_ring.recv(timeout_s=0.2)
                if frame is None:
                    continue
                t_recv = time.perf_counter_ns() if _spans.active() else 0
                if t_recv:
                    meta = frame_meta(frame)
                    _spans.record_span("hop.transport_resp",
                                       meta["t_send_ns"], t_recv,
                                       rows=meta["count"])
                kind, rows = unpack_frame(frame)
                if kind == KIND_ACK:
                    for rid, status, evidence in rows:
                        self._on_ack(rid, status, evidence)
                elif kind == KIND_RESULT:
                    self._on_results(rows)
                    if t_recv:
                        # hop.complete: result frame received → futures
                        # resolved (callbacks run inline above)
                        _spans.record_span("hop.complete", t_recv,
                                           rows=len(rows))
        except Exception as exc:  # noqa: BLE001 — a dead plane fails all
            if not self._stop:
                self._on_dead(f"shm data plane failed: {exc!r}")

    def stop(self) -> None:
        with self._plock:
            self._stop = True
        self.req_ring.close()
        self.resp_ring.close()
        for fd in (self._req_bell, self._resp_bell):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
                with _BELL_LOCK:
                    _BELLS.discard(fd)
        self._req_bell = self._resp_bell = None


# -- child side: the data-plane server ----------------------------------------


def _send_until_stopped(ring: ShmRing, frame: bytes, stopping: Callable,
                        attempt_timeout_s: float = 1.0) -> bool:
    """Send a committed response frame, retrying across ring-full stalls
    until it lands or the data plane is stopping. A full response ring
    on a HEALTHY router is transient backpressure (its reader thread can
    be held up by requeue work for seconds) — dropping the frame would
    strand resolved futures forever, so backpressure holds THIS child
    thread instead; a dead router sets the stop flag via the control
    socket's EOF and the retry exits."""
    while True:
        try:
            ring.send(frame, timeout_s=attempt_timeout_s)
            return True
        except RingFullError:
            if stopping():
                return False


class _ResultCoalescer:
    """Child-side mirror of the front-end coalescer: done-callbacks push
    (id, ok, value); ONE flusher thread packs everything pending into a
    RESULT frame, so a bucket dispatch completing 64 futures crosses the
    boundary as one or two frames, not 64 — the sequential callbacks
    land while the flusher is mid-send and ride the next frame. (The
    child's CPU is otherwise idle; the wakeup hop is cheap there, and
    fewer/fatter frames is what keeps the PARENT's reader off its GIL.)"""

    # a RESULT row is 36 B of columns; bound rows per frame well inside
    # any slot geometry
    def __init__(self, ring: ShmRing, send_timeout_s: float):
        self._ring = ring
        self._send_timeout_s = send_timeout_s
        self._pending: List[Tuple[int, bool, object]] = []
        self._cv = threading.Condition()
        self._stop = False
        self._max_rows = max(1, min(256, ring.payload_capacity // 64))
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fmrp-shm-results"
        )
        self._thread.start()

    def push(self, req_id: int, ok: bool, value) -> None:
        t_push = time.perf_counter_ns() if _spans.active() else 0
        with self._cv:
            if self._stop:
                return
            self._pending.append((req_id, ok, value, t_push))
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop and not self._pending:
                    return
                taken = self._pending[:self._max_rows]
                del self._pending[:self._max_rows]
            batch = [(rid, ok, val) for rid, ok, val, _ in taken]
            t_first = min((t for *_, t in taken if t), default=0)
            stopping = lambda: self._stop  # noqa: E731
            attempt_s = min(1.0, self._send_timeout_s)
            try:
                _send_until_stopped(self._ring, pack_results(batch),
                                    stopping, attempt_s)
                if t_first:
                    # hop.result_send: first completion in the batch →
                    # its result frame committed on the ring
                    _spans.record_span("hop.result_send", t_first,
                                       rows=len(batch))
            except ValueError:
                # over-capacity frame (a batch of failures whose pickled
                # tails add up): HALVE and retry, never drop a healthy
                # parent's results — a lone over-capacity entry sheds
                # its exception payload (the truncated repr still
                # travels, re-raised parent-side as a RuntimeError)
                parts = [batch]
                while parts:
                    part = parts.pop(0)
                    try:
                        if len(part) == 1:
                            rid, ok, val = part[0]
                            _send_until_stopped(
                                self._ring,
                                pack_results([(
                                    rid, ok,
                                    val if ok
                                    else RuntimeError(repr(val)[:300]),
                                )]),
                                stopping,
                            )
                            continue
                        _send_until_stopped(self._ring,
                                            pack_results(part), stopping)
                    except ValueError:
                        if len(part) > 1:
                            mid = len(part) // 2
                            parts[:0] = [part[:mid], part[mid:]]
                        # a single entry STILL failing after the shed is
                        # unreachable (fixed-width columns only); drop

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()


def serve_data_plane(service, req_ring: ShmRing, resp_ring: ShmRing,
                     stop: threading.Event,
                     send_timeout_s: float = 5.0) -> None:
    """The replica child's data-plane loop: unpack SUBMIT strips, feed
    the service, report REJECTS in an ACK frame (accepts are implicit —
    the parent admits optimistically against the same ``max_queue``
    ceiling this service enforces, so the reject path is the rare
    disagreement, not the per-row handshake), and stream RESULT frames
    as the inner futures resolve. Runs until ``stop`` is set (the
    control-plane ``close`` verb or parent EOF)."""
    from fm_returnprediction_tpu_torch.serving.batcher import QueueFullError

    results = _ResultCoalescer(resp_ring, send_timeout_s)
    try:
        while not stop.is_set():
            # the child's CPU is idle between strips: a 200 µs hot spin
            # catches the next frame without costing the router a wakeup
            try:
                frame = req_ring.recv(timeout_s=0.1, spin_s=2e-4)
            except Exception:  # noqa: BLE001 — ring torn down under us
                break
            if frame is None:
                continue
            # GREEDY drain: take every frame already committed before
            # touching the service — the whole backlog then enters the
            # batcher through ONE submit_many lock acquisition, so the
            # flusher sees real queue depth and dispatches full batches
            # (absorbed row-by-row, the dispatch threads starve this
            # loop and batches collapse to strip size)
            frames = [frame]
            while len(frames) < 64:
                nxt = req_ring.recv(timeout_s=0.0)
                if nxt is None:
                    break
                frames.append(nxt)
            t_recv = time.perf_counter_ns() if _spans.active() else 0
            rows: List[Tuple[int, object, object]] = []
            for fr in frames:
                # PER-FRAME isolation: one undecodable frame (a pickle
                # tail whose class does not import child-side) must fail
                # only ITS rows silently-absent, never discard the other
                # drained frames' healthy coalesced requests
                try:
                    kind, frame_rows = unpack_frame(fr)
                except Exception:  # noqa: BLE001 — skip the bad frame
                    continue
                if kind == KIND_SUBMIT:
                    if t_recv:
                        # hop.transport_req: router's send stamp → this
                        # child decoded the frame (ring wait + wire)
                        meta = frame_meta(fr)
                        _spans.record_span(
                            "hop.transport_req", meta["t_send_ns"],
                            t_recv, rows=meta["count"],
                            trace=meta["trace_id"],
                        )
                    rows.extend(frame_rows)
            if not rows:
                continue
            try:
                outs = service.submit_many(
                    [(month, x) for _, month, x in rows]
                )
            except Exception as exc:  # noqa: BLE001 — a wholesale
                # failure must reach the callers as per-row errors, not
                # kill the serve thread and blackhole the replica
                outs = [("err", exc)] * len(rows)

            def _done(fut, rid, t0):
                ok = fut.exception() is None
                if t0:
                    # hop.solve: rows decoded → this future resolved
                    # (batcher queue wait + the solve itself)
                    _spans.record_span("hop.solve", t0, req=rid)
                results.push(rid, ok,
                             fut.result() if ok else fut.exception())

            rej_ids, rej_statuses, evidence = [], [], {}
            for (rid, _, _), (ok, val) in zip(rows, outs):
                if ok == "ok":
                    val.add_done_callback(
                        lambda fut, i=rid, t0=t_recv: _done(fut, i, t0)
                    )
                    continue
                if isinstance(val, QueueFullError):
                    evidence[len(rej_ids)] = {
                        "message": str(val),
                        "queue_depth": val.queue_depth,
                        "max_queue": val.max_queue,
                    }
                    rej_statuses.append(STATUS_QUEUE_FULL)
                elif isinstance(val, RuntimeError):
                    evidence[len(rej_ids)] = {"message": str(val)}
                    rej_statuses.append(STATUS_CLOSED)
                else:
                    blob = _bounded_exc_blob(val)
                    evidence[len(rej_ids)] = {"exc": blob,
                                              "error": repr(val)[:300]}
                    rej_statuses.append(STATUS_ERROR)
                rej_ids.append(rid)
            # CHUNKED acks: a queue-full storm can reject a whole greedy
            # drain's worth of rows at once, and one frame carrying every
            # pickled evidence tail could exceed its slot — which must
            # degrade to smaller frames, never to a dead serve thread
            for lo in range(0, len(rej_ids), 32):
                chunk_ids = rej_ids[lo:lo + 32]
                chunk_st = rej_statuses[lo:lo + 32]
                chunk_ev = {i - lo: evidence[i]
                            for i in range(lo, lo + len(chunk_ids))
                            if i in evidence}
                try:
                    _send_until_stopped(
                        resp_ring, pack_ack(chunk_ids, chunk_st, chunk_ev),
                        stop.is_set,
                    )
                except ValueError:
                    # still too fat (pathological evidence): drop the
                    # payloads, keep the statuses — the parent maps a
                    # bare status to its typed exception either way
                    try:
                        _send_until_stopped(
                            resp_ring, pack_ack(chunk_ids, chunk_st, None),
                            stop.is_set,
                        )
                    except ValueError:
                        break
    finally:
        results.stop()
