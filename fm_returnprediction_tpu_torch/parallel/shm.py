"""Shared-memory primitives: SPSC frame rings and mapped array segments.

``parallel.distributed`` gives the repo one wire format, length-prefixed
pickle frames over TCP: the right shape for control-plane verbs and the
wrong one for the data plane. This module is the data plane's home:

:class:`ShmRing`
    A fixed-slot single-producer/single-consumer frame ring over one
    ``multiprocessing.shared_memory`` segment. Fixed-width binary frames,
    no pickle on the hot path, and a sequence/commit protocol that makes
    a torn frame read as absent:

    - every slot carries a ``commit`` word holding the global sequence
      number of its frame; the writer copies payload and length first and
      writes ``commit`` last, so a writer that dies mid-frame leaves
      ``commit`` at the previous lap's value and the reader never sees
      the frame;
    - the reader acknowledges consumption by publishing its cumulative
      ``tail``; the writer refuses to lap it;
    - ring-full is backpressure: the writer stalls (counted,
      ``fmrp_transport_ring_full_stalls_total``) and raises
      :class:`RingFullError` past its deadline.

:class:`ShmArraySpec` / :func:`publish_array` / :func:`attach_array`
    Numpy arrays published once into a named segment and mapped by the
    consumer: the multi-process spec grid's panel and Gram-stats path.

Capacity. ``/dev/shm`` is a tmpfs, often 64 MiB in a container, and a
store past its size is a SIGBUS, not an exception. :func:`publish_array`
checks the free bytes (``os.statvfs``) before it creates a segment and
raises :class:`ShmCapacityError` naming the size; :func:`shm_available`
with ``nbytes`` says whether that many bytes fit, which is how the
transport resolvers' ``auto`` reads "where POSIX shm works".

Resource tracker. Attaching to an existing segment registers it with the
attaching process's ``resource_tracker``, whose exit would unlink a
segment it does not own (bpo-38119; ``SharedMemory(track=)`` arrives only
in Python 3.13). ``attach_*`` therefore unregisters at once: the creator
owns the name and unlinks it.

Atomicity: the commit word is an aligned 8-byte store written after the
payload stores; on x86 (TSO) "commit visible ⇒ payload visible" holds,
and a torn commit read can only misread as not committed.
"""

from __future__ import annotations

import os
import secrets
import select
import struct
import threading
import time
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

from fm_returnprediction_tpu_torch.resilience.faults import fault_site

__all__ = [
    "RingFullError",
    "ShmCapacityError",
    "ShmArraySpec",
    "ShmRing",
    "attach_array",
    "attach_ring",
    "owned_segments",
    "publish_array",
    "release_segment",
    "shm_available",
    "shm_free_bytes",
    "sweep_segments",
    "transport_instruments",
]

_MAGIC = 0x464D5250_53484D31  # "FMRPSHM1"
# magic, nslots, slot_bytes, tail, want_bell (reader-blocked flag), pad
_HDR = struct.Struct("<QQQQQ3Q")
_SLOT_HDR = struct.Struct("<QI4x")      # commit seq, payload length, pad
HEADER_BYTES = _HDR.size
SLOT_HEADER_BYTES = _SLOT_HDR.size
_TAIL_OFF = 24                          # offset of the tail word in _HDR
_WANT_BELL_OFF = 32                     # reader sets 1 before blocking


class RingFullError(RuntimeError):
    """The writer could not place a frame before its deadline: the
    reader has not released enough slots (transport backpressure). The
    serving layer translates this into the typed retriable
    ``ServiceOverloadError`` — a ring-full data plane is an overloaded
    replica, not a protocol failure."""

    def __init__(self, message: str, stalled_s: float = 0.0):
        super().__init__(message)
        self.stalled_s = float(stalled_s)


class ShmCapacityError(OSError):
    """A segment would not fit the free space of ``/dev/shm``: raised
    before anything is created or written (a store past a tmpfs's size
    is a SIGBUS)."""

    def __init__(self, message: str, needed: int = 0, free: int = 0):
        super().__init__(message)
        self.needed = int(needed)
        self.free = int(free)


SHM_DIR = "/dev/shm"


def shm_free_bytes() -> Optional[int]:
    """Free bytes of ``/dev/shm`` (None where it cannot be read)."""
    try:
        st = os.statvfs(SHM_DIR)
    except OSError:
        return None
    return int(st.f_bavail) * int(st.f_frsize)


def _check_capacity(nbytes: int, what: str) -> None:
    free = shm_free_bytes()
    if free is not None and nbytes > free:
        raise ShmCapacityError(
            f"{what} needs {nbytes:,} bytes of shared memory but {SHM_DIR} has "
            f"{free:,} free", needed=nbytes, free=free)


def shm_available(nbytes: int = 0) -> bool:
    """Whether POSIX shared memory is usable here and, with ``nbytes``,
    whether that many bytes fit in ``/dev/shm`` (the transport
    resolvers' probe for ``auto``)."""
    if nbytes:
        free = shm_free_bytes()
        if free is not None and nbytes > free:
            return False
    try:
        seg = shared_memory.SharedMemory(create=True, size=16)
    except (OSError, ValueError):
        return False
    seg.close()
    seg.unlink()
    return True


def _unregister(name: str) -> None:
    """Drop a segment from THIS process's resource tracker (attach-side
    only — see the module docstring's bpo-38119 note)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:  # noqa: BLE001 — tracker variance across minors
        pass


# -- owned-segment ledger (the fd/segment hygiene audit) ---------------------
#
# Every segment THIS process creates (ring or mapped array) is entered in a
# module ledger at creation and struck at unlink. Normal teardown strikes
# every entry; anything still listed after a crash path is a LEAK — a name
# in /dev/shm with no owner left to unlink it. ``sweep_segments`` (the
# topology controller's post-repair sweep) reaps those and counts them into
# ``fmrp_topology_leaked_segments_total``, which the chaos suite asserts
# stays zero across every kill/repair cycle.

_SEG_LOCK = threading.Lock()
_OWNED: set = set()


def _ledger_add(name: str) -> None:
    with _SEG_LOCK:
        _OWNED.add(name)


def _ledger_drop(name: str) -> None:
    with _SEG_LOCK:
        _OWNED.discard(name)


def owned_segments() -> Tuple[str, ...]:
    """Snapshot of segments this process created and has not yet
    unlinked — live transports plus any leaks-in-waiting."""
    with _SEG_LOCK:
        return tuple(sorted(_OWNED))


def release_segment(seg: shared_memory.SharedMemory) -> None:
    """Owner-side disposal of a published segment: close, unlink, strike
    the ledger entry. The one call every owner teardown path uses, so the
    ledger's residue is exactly the leak set."""
    name = seg.name
    try:
        seg.close()
    except (OSError, BufferError):
        pass
    try:
        seg.unlink()
    except OSError:
        _unregister(name)  # already gone: drop OUR tracker entry too
    _ledger_drop(name)


def sweep_segments() -> List[str]:
    """Reap every still-ledgered segment: unlink the ones that still
    exist and count them as leaks. Call AFTER tearing down everything
    you own (the controller does, post-repair / post-campaign) — a live
    fleet's segments read as leaks to this function by design, because
    at sweep time nothing should be live."""
    with _SEG_LOCK:
        names = sorted(_OWNED)
        _OWNED.clear()
    leaked: List[str] = []
    for name in names:
        try:
            seg = shared_memory.SharedMemory(name=name)
        except (FileNotFoundError, OSError):
            continue  # owner unlinked it without striking: not a leak
        _unregister(name)
        try:
            seg.close()
            seg.unlink()
        except OSError:
            continue
        leaked.append(name)
    if leaked:
        from fm_returnprediction_tpu_torch import telemetry

        telemetry.registry().counter(
            "fmrp_topology_leaked_segments_total",
            help="shm segments still linked when the topology sweep ran",
        ).inc(len(leaked))
    return leaked


def transport_instruments(transport: str, replica: str = "") -> dict:
    """The transport observability contract in ONE place: byte/frame/
    stall counters and the batch-occupancy histogram, labelled by
    transport (``shm``/``socket``/``grid_shm``/``grid_frames``) and
    replica/rank. Both the shm rings and the socket replica transport
    report through these, so a socket-vs-shm comparison reads one
    family."""
    from fm_returnprediction_tpu_torch import telemetry

    reg = telemetry.registry()
    labels = {"transport": transport}
    if replica:
        labels["replica"] = replica
    return {
        "bytes_out": reg.counter(
            "fmrp_transport_bytes_total",
            help="data-plane payload bytes by transport and direction",
            direction="sent", **labels,
        ),
        "bytes_in": reg.counter(
            "fmrp_transport_bytes_total",
            help="data-plane payload bytes by transport and direction",
            direction="received", **labels,
        ),
        "frames": reg.counter(
            "fmrp_transport_frames_total",
            help="data-plane frames by transport",
            **labels,
        ),
        "stalls": reg.counter(
            "fmrp_transport_ring_full_stalls_total",
            help="writer stalls waiting on a full ring (backpressure)",
            **labels,
        ),
        "batch_rows": reg.histogram(
            "fmrp_transport_batch_rows",
            help="rows coalesced per data-plane frame",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
            **labels,
        ),
    }


class ShmRing:
    """One direction of a data plane: a fixed-slot SPSC frame ring.

    Exactly one WRITER process and one READER process (each side may
    serialize its own threads through the internal lock). Created by
    the owner (``create=True``), attached by the guest via
    :func:`attach_ring`; the owner unlinks.
    """

    def __init__(self, name: Optional[str] = None, *, slots: int = 64,
                 slot_bytes: int = 65536, create: bool = False,
                 instruments: Optional[dict] = None,
                 doorbell_fd: Optional[int] = None):
        if create:
            if slots < 2 or slot_bytes <= SLOT_HEADER_BYTES:
                raise ValueError("ring needs ≥2 slots and room for payload")
            name = name or f"fmrp{os.getpid():x}{secrets.token_hex(4)}"
            size = HEADER_BYTES + slots * slot_bytes
            _check_capacity(size, "a frame ring")
            self._seg = shared_memory.SharedMemory(
                name=name, create=True, size=size
            )
            _ledger_add(self._seg.name)
            _HDR.pack_into(self._seg.buf, 0, _MAGIC, slots, slot_bytes,
                           0, 0, 0, 0, 0)
        else:
            if name is None:
                raise ValueError("attaching needs the ring's name")
            self._seg = shared_memory.SharedMemory(name=name)
            _unregister(self._seg.name)
            magic, slots, slot_bytes = _HDR.unpack_from(
                self._seg.buf, 0)[:3]
            if magic != _MAGIC:
                self._seg.close()
                raise ValueError(f"segment {name!r} is not an fmrp ring")
        self.name = self._seg.name
        self.owner = bool(create)
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self.payload_capacity = self.slot_bytes - SLOT_HEADER_BYTES
        self._buf = self._seg.buf
        self._lock = threading.Lock()
        self._wseq = 0   # last committed write sequence (writer side)
        self._rseq = 0   # last consumed sequence (reader side)
        self._closed = False
        self._inst = instruments or {}
        # doorbell: an (inherited) eventfd the writer rings after every
        # commit and the reader blocks on — boundary-crossing latency is
        # then one kernel wakeup (~10 µs) instead of a sleep-poll tick.
        # None (no eventfd on this platform / not wired) = poll fallback.
        self._bell = doorbell_fd

    # -- header words ------------------------------------------------------

    def _tail(self) -> int:
        return struct.unpack_from("<Q", self._buf, _TAIL_OFF)[0]

    def _set_tail(self, seq: int) -> None:
        struct.pack_into("<Q", self._buf, _TAIL_OFF, seq)

    def _want_bell(self) -> int:
        return struct.unpack_from("<Q", self._buf, _WANT_BELL_OFF)[0]

    def _set_want_bell(self, v: int) -> None:
        struct.pack_into("<Q", self._buf, _WANT_BELL_OFF, v)

    def _slot_off(self, seq: int) -> int:
        return HEADER_BYTES + ((seq - 1) % self.slots) * self.slot_bytes

    def watermark(self) -> Tuple[int, int]:
        """(produced, consumed) as visible from THIS side: the local
        write/read sequence paired with the shared tail word. On a writer
        handle that is (frames committed, frames the peer acknowledged) —
        the liveness probe's ring-progress watermark: a gap that fails to
        drain between two probe samples classifies the peer as
        RING-STALLED (pid alive, control plane answering, data plane
        wedged), distinctly from killed or hung."""
        with self._lock:
            if self._closed or self._buf is None:
                return (max(self._wseq, self._rseq), self._rseq)
            return (max(self._wseq, self._rseq), self._tail())

    # -- writer ------------------------------------------------------------

    def send(self, payload: bytes, timeout_s: float = 5.0) -> None:
        """Place one frame; raises :class:`RingFullError` if the reader
        does not release a slot within ``timeout_s``. The commit word is
        written LAST — a writer death anywhere before that line leaves a
        frame that reads as absent."""
        n = len(payload)
        if n > self.payload_capacity:
            raise ValueError(
                f"frame of {n} B exceeds slot payload capacity "
                f"{self.payload_capacity} B"
            )
        with self._lock:
            if self._closed:
                raise RingFullError("ring is closed")
            seq = self._wseq + 1
            if seq - self._tail() > self.slots:
                # backpressure: stall (counted once per episode), then
                # typed failure past the deadline
                inst = self._inst.get("stalls")
                if inst is not None:
                    inst.inc()
                deadline = time.monotonic() + timeout_s
                while seq - self._tail() > self.slots:
                    if self._closed:
                        raise RingFullError("ring closed while stalled")
                    now = time.monotonic()
                    if now >= deadline:
                        raise RingFullError(
                            f"ring {self.name} full for {timeout_s:.3f}s "
                            f"(reader at {self._tail()}, writer at {seq})",
                            stalled_s=timeout_s,
                        )
                    time.sleep(1e-4)  # stall is the rare path: plain poll
            off = self._slot_off(seq)
            data_off = off + SLOT_HEADER_BYTES
            self._buf[data_off:data_off + n] = payload
            struct.pack_into("<I", self._buf, off + 8, n)
            # the exactly-once seam: payload and length are down, commit
            # is not — a SIGKILL landing at this site (chaos campaign)
            # must leave a frame the reader never observes
            fault_site("shm.ring.commit")
            # commit LAST: the frame exists only once this word reads seq
            struct.pack_into("<Q", self._buf, off, seq)
            self._wseq = seq
            # ring the doorbell only when the reader says it is blocked
            # (want_bell, set before it enters select and re-checks the
            # commit word — the flag protocol can delay a wakeup to the
            # bounded select timeout only if the flag store itself loses
            # the race, which the reader's re-check closes). An awake
            # reader in its greedy drain sees the commit without a
            # syscall; the eventfd write is ~35 µs when it wakes a
            # blocked peer, the dominant cost of a per-frame bell.
            if self._bell is not None and self._want_bell():
                try:
                    os.eventfd_write(self._bell, 1)
                except OSError:
                    pass  # reader gone; its own death path owns cleanup
        bo = self._inst.get("bytes_out")
        if bo is not None:
            bo.inc(n)
        fr = self._inst.get("frames")
        if fr is not None:
            fr.inc()

    # -- reader ------------------------------------------------------------

    def recv(self, timeout_s: float = 0.2,
             spin_s: float = 0.0) -> Optional[bytes]:
        """The next frame's payload (copied out), or None when no frame
        commits within ``timeout_s`` — which is also exactly what a torn
        frame looks like: its commit word never reaches the expected
        sequence, so the reader simply keeps not seeing it.

        ``spin_s``: busy-poll the commit word that long before blocking
        on the doorbell — for readers whose CPU is otherwise idle (the
        replica child), a short spin catches the next frame without
        costing the WRITER an eventfd wakeup syscall."""
        with self._lock:
            seq = self._rseq + 1
            off = self._slot_off(seq)
            deadline = time.monotonic() + timeout_s
            spin_until = time.monotonic() + spin_s if spin_s else 0.0
            delay = 2e-5
            while True:
                if self._closed:
                    return None
                (commit,) = struct.unpack_from("<Q", self._buf, off)
                if commit == seq:
                    break
                now = time.monotonic()
                if now >= deadline:
                    return None
                if now < spin_until:
                    continue  # hot spin: idle-CPU readers only
                if self._bell is not None:
                    # flag → re-check → block: the writer rings only for
                    # a reader that declared itself blocked, and the
                    # re-check closes the flag/commit race (a frame
                    # committed before the flag store is seen here, not
                    # slept through)
                    try:
                        self._set_want_bell(1)
                        (commit,) = struct.unpack_from(
                            "<Q", self._buf, off)
                        if commit == seq:
                            self._set_want_bell(0)
                            break
                        r, _, _ = select.select(
                            [self._bell], [], [],
                            min(deadline - now, 0.05),
                        )
                        self._set_want_bell(0)
                        if r:
                            os.read(self._bell, 8)
                    except (OSError, ValueError):
                        return None  # fd closed under us: ring is down
                else:
                    time.sleep(delay)
                    delay = min(delay * 2, 2e-4)
            (n,) = struct.unpack_from("<I", self._buf, off + 8)
            data_off = off + SLOT_HEADER_BYTES
            out = bytes(self._buf[data_off:data_off + n])
            # release the slot only after the copy-out
            self._set_tail(seq)
            self._rseq = seq
        bi = self._inst.get("bytes_in")
        if bi is not None:
            bi.inc(len(out))
        return out

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        # the flag is set BEFORE taking the lock: a sender stalled in
        # its ring-full loop (or a reader polling) holds the lock for up
        # to its full timeout, checks ``_closed`` every iteration, and
        # must observe the close promptly — waiting for the lock here
        # would serialize teardown behind the very stall being torn down
        self._closed = True
        with self._lock:
            self._buf = None
        try:
            self._seg.close()
        except (OSError, BufferError):
            pass
        if self.owner:
            try:
                self._seg.unlink()
            except OSError:
                # already gone (a crashed peer's resource tracker beat
                # us to it) — still drop OUR tracker entry, or it warns
                # about a "leaked" segment at interpreter exit
                _unregister(self._seg.name)
            _ledger_drop(self._seg.name)

    def __del__(self):  # best-effort: rings must not outlive the session
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def attach_ring(name: str, instruments: Optional[dict] = None,
                doorbell_fd: Optional[int] = None) -> ShmRing:
    """Guest-side handle on an existing ring (geometry read from the
    segment header; never unlinks). ``doorbell_fd`` is the creator's
    inherited eventfd number (``pass_fds``), or None for poll mode."""
    return ShmRing(name, create=False, instruments=instruments,
                   doorbell_fd=doorbell_fd)


# -- mapped numpy segments ----------------------------------------------------


@dataclass(frozen=True)
class ShmArraySpec:
    """What a consumer needs to map a published array: segment name +
    layout. Serializes as a plain dict (the job-frame control plane)."""

    name: str
    shape: Tuple[int, ...]
    dtype: str

    def to_meta(self) -> dict:
        return {"name": self.name, "shape": list(self.shape),
                "dtype": self.dtype}

    @classmethod
    def from_meta(cls, meta: dict) -> "ShmArraySpec":
        return cls(name=str(meta["name"]),
                   shape=tuple(int(s) for s in meta["shape"]),
                   dtype=str(meta["dtype"]))


def publish_array(arr, name: Optional[str] = None
                  ) -> Tuple[shared_memory.SharedMemory, ShmArraySpec]:
    """Copy ``arr`` once into a named segment; the caller owns the
    handle (keep it referenced, :func:`release_segment` when done — it
    strikes the hygiene ledger along with the unlink). Raises
    :class:`ShmCapacityError` before creating anything when the array
    does not fit ``/dev/shm``."""
    import numpy as np

    arr = np.ascontiguousarray(arr)
    _check_capacity(int(arr.nbytes), f"an array of shape {arr.shape} {arr.dtype}")
    name = name or f"fmrp{os.getpid():x}{secrets.token_hex(4)}"
    seg = shared_memory.SharedMemory(
        name=name, create=True, size=max(int(arr.nbytes), 1)
    )
    _ledger_add(seg.name)
    view = np.ndarray(arr.shape, dtype=arr.dtype, buffer=seg.buf)
    view[...] = arr
    del view
    return seg, ShmArraySpec(seg.name, tuple(arr.shape), str(arr.dtype))


def attach_array(spec: ShmArraySpec
                 ) -> Tuple[shared_memory.SharedMemory, "object"]:
    """Map a published array in place (zero copy). Returns the segment
    handle (hold it as long as the view lives, ``close()`` after —
    never unlink: the publisher owns the name) and the numpy view."""
    import numpy as np

    seg = shared_memory.SharedMemory(name=spec.name)
    _unregister(seg.name)
    view = np.ndarray(spec.shape, dtype=np.dtype(spec.dtype), buffer=seg.buf)
    return seg, view
