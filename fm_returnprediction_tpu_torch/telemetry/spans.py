"""Span tracer: nested, context-propagated host spans on monotonic clocks.

- a **span** is a named interval with a ``trace_id``/``span_id``/
  ``parent_id`` triple; spans nest through a ``contextvars.ContextVar``,
  so ``run_pipeline`` → stage → sub-stage → retry attempt → serving
  dispatch share one trace and reconstruct as a tree;
- **cross-thread propagation is explicit**: a thread does not inherit
  its parent's context, so code that hops threads (the serving executor's
  dispatch watchdog, the microbatcher's flusher) takes the current span
  with :func:`capture` and re-enters it with :func:`attach`;
- **events** are points in time (a retry backoff, a checkpoint hit, a
  quarantine) attached to the current span when one is open, else kept
  standalone;
- :func:`device_sync` is the ``FMRP_SYNC_STAGES``-gated barrier: it
  synchronizes the devices of the given tensors (a no-op on the CPU) and,
  with tracing on, records the measured wait as a ``device_sync`` event.

OFF BY DEFAULT, and off means off: :func:`span` costs one module-global
read and returns a shared no-op context manager. Spans are host-side
only: they never touch a tensor, so a run's numbers are bit-identical
with tracing on or off. The switch is ``FMRP_TELEMETRY`` (or implicitly
a configured trace directory, ``FMRP_TRACE_DIR`` /
``run_pipeline(trace_dir=...)``).

Span and trace ids are small sequential integers (deterministic within a
process after :func:`reset`); timestamps are ``perf_counter_ns``,
anchored once to the epoch at import, so the exported Chrome trace lines
up with a ``torch.profiler`` trace of the same run in Perfetto.

While a ``torch.profiler`` capture is live (``telemetry.perf.profiling``)
the annotation factory is ``torch.profiler.record_function``: every armed
span then also names its interval on the profiler's timeline.

:func:`record_span` collects an interval from explicit stamps (the
fleet's request spans and the cross-process hops). A child process
spawned inside a traced span installs that span as its remote parent
(:func:`set_remote_context`, from ``telemetry.distributed``): every root
span it opens then carries ``remote_trace``/``remote_parent`` attrs,
which is how the timeline merge joins child spans to the router's
without sharing span ids across processes.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from contextvars import ContextVar
from typing import Dict, List, Optional

__all__ = [
    "Span",
    "active",
    "set_enabled",
    "enabled",
    "span",
    "event",
    "capture",
    "attach",
    "device_sync",
    "timed",
    "current_span",
    "record_span",
    "finished_spans",
    "standalone_events",
    "collector_stats",
    "reset",
    "trace_dir",
    "set_trace_dir",
    "annotation_factory",
    "set_annotation_factory",
    "remote_context",
    "set_remote_context",
]

_TRUE = ("1", "on", "true", "yes")


def _env_enabled() -> bool:
    if os.environ.get("FMRP_TRACE_DIR"):
        return True
    return os.environ.get("FMRP_TELEMETRY", "0").strip().lower() in _TRUE


_ENABLED: bool = _env_enabled()
_TRACE_DIR: Optional[str] = os.environ.get("FMRP_TRACE_DIR") or None

# wall-clock ns at perf_counter_ns() == 0: monotonic timestamps inside the
# process, epoch placement in the exporters
EPOCH_ANCHOR_NS: int = time.time_ns() - time.perf_counter_ns()

_IDS = itertools.count(1)
_LOCK = threading.Lock()
_SPANS: List["Span"] = []  # finished spans, append order
_EVENTS: List[dict] = []  # standalone events (no enclosing span)
_MAX_RECORDS = int(os.environ.get("FMRP_TELEMETRY_MAX_SPANS", "200000"))
_DROPPED = 0

_CURRENT: ContextVar[Optional["Span"]] = ContextVar("fmrp_current_span", default=None)

# torch.profiler.record_function while a profiler capture is live, else
# None: the span hot path then never touches torch
_ANNOTATION_FACTORY = None


def annotation_factory():
    return _ANNOTATION_FACTORY


def set_annotation_factory(factory) -> None:
    global _ANNOTATION_FACTORY
    _ANNOTATION_FACTORY = factory


def active() -> bool:
    """Whether span collection is armed (one module-global read)."""
    return _ENABLED


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


@contextlib.contextmanager
def enabled(flag: bool):
    """Force tracing on or off for a block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    try:
        yield
    finally:
        _ENABLED = prev


def trace_dir() -> Optional[str]:
    """The configured export directory (``FMRP_TRACE_DIR`` /
    ``set_trace_dir``), or None when exports are unarmed."""
    return _TRACE_DIR


def set_trace_dir(path: Optional[str]) -> None:
    global _TRACE_DIR
    _TRACE_DIR = str(path) if path else None


_REMOTE_CTX: Optional[tuple] = None  # (trace_id, span_id) of the remote parent


def remote_context() -> Optional[tuple]:
    """The installed remote parent ``(trace_id, span_id)``, or None."""
    return _REMOTE_CTX


def set_remote_context(trace_id: Optional[int], span_id: Optional[int] = None) -> None:
    """Install (or clear, with ``None``) the remote parent context, the
    child-side half of cross-process trace propagation."""
    global _REMOTE_CTX
    _REMOTE_CTX = None if trace_id is None else (int(trace_id), int(span_id or 0))


class Span:
    """One finished or open interval. Times are ``perf_counter_ns``."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id", "t0_ns", "t1_ns",
                 "thread_id", "thread_name", "attrs", "events")

    def __init__(self, name: str, cat: str, attrs: Dict[str, object]):
        parent = _CURRENT.get()
        self.name = name
        self.cat = cat
        self.span_id = next(_IDS)
        if parent is None:
            self.trace_id = self.span_id
            self.parent_id = None
            if _REMOTE_CTX is not None:
                # a root span in a child process names the remote request
                # span by attribute, not by id
                attrs = {**attrs, "remote_trace": _REMOTE_CTX[0],
                         "remote_parent": _REMOTE_CTX[1]}
        else:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self.attrs = attrs
        self.events: List[tuple] = []  # (name, t_ns, attrs)
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns: Optional[int] = None

    @property
    def duration_s(self) -> float:
        end = self.t1_ns if self.t1_ns is not None else time.perf_counter_ns()
        return (end - self.t0_ns) / 1e9

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, id={self.span_id}, trace={self.trace_id}, "
                f"parent={self.parent_id}, {self.duration_s * 1e3:.3f}ms)")


def _collect_span(s: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_SPANS) >= _MAX_RECORDS:
            _DROPPED += 1
            return
        _SPANS.append(s)


class _SpanCtx:
    """Context manager for one live span (allocated only when armed)."""

    __slots__ = ("_name", "_cat", "_attrs", "_span", "_token", "_ann")

    def __init__(self, name: str, cat: str, attrs: Dict[str, object]):
        self._name = name
        self._cat = cat
        self._attrs = attrs

    def __enter__(self) -> Span:
        self._span = Span(self._name, self._cat, self._attrs)
        self._token = _CURRENT.set(self._span)
        factory = _ANNOTATION_FACTORY
        self._ann = None
        if factory is not None:
            # name the interval on the live profiler's timeline too
            try:
                self._ann = factory(self._name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 — profiling must never break
                self._ann = None  # the instrumented code path
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self._span
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001 — see __enter__
                pass
        s.t1_ns = time.perf_counter_ns()
        if exc is not None:
            s.attrs = {**s.attrs, "error": repr(exc)[:200]}
        _CURRENT.reset(self._token)
        _collect_span(s)
        return False


class _Noop:
    """Shared do-nothing context manager: the tracing-off fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


def span(name: str, cat: str = "span", **attrs):
    """Open a span named ``name`` for the ``with`` block. With tracing off
    this returns a shared no-op context manager."""
    if not _ENABLED:
        return _NOOP
    return _SpanCtx(name, cat, attrs)


def event(name: str, cat: str = "event", **attrs) -> None:
    """Record a point-in-time event on the current span (standalone when no
    span is open). No-op when tracing is off."""
    global _DROPPED
    if not _ENABLED:
        return
    t_ns = time.perf_counter_ns()
    cur = _CURRENT.get()
    if cur is not None:
        cur.events.append((name, t_ns, attrs))
        return
    t = threading.current_thread()
    rec = {"name": name, "cat": cat, "t_ns": t_ns, "thread_id": t.ident or 0,
           "thread_name": t.name, "attrs": attrs}
    with _LOCK:
        if len(_EVENTS) >= _MAX_RECORDS:
            _DROPPED += 1
        else:
            _EVENTS.append(rec)


def record_span(name: str, t0_ns: int, t1_ns: Optional[int] = None,
                cat: str = "hop", **attrs) -> Optional[Span]:
    """Collect an interval that has already ended, from explicit
    ``perf_counter_ns`` stamps (the fleet's ``fleet.request`` and
    ``hop.admit``: the start stamp is taken at admission, the span is
    recorded when the request reaches its terminal). No-op returning None
    when tracing is off or the start stamp is unset (0)."""
    if not _ENABLED or not t0_ns:
        return None
    s = Span(name, cat, attrs)
    s.t0_ns = int(t0_ns)
    s.t1_ns = int(t1_ns if t1_ns is not None else time.perf_counter_ns())
    _collect_span(s)
    return s


def current_span() -> Optional[Span]:
    """The innermost open span in this thread's context, if any."""
    return _CURRENT.get()


def capture() -> Optional[Span]:
    """The current span, for handing to another thread (``attach``). None
    when tracing is off or no span is open."""
    if not _ENABLED:
        return None
    return _CURRENT.get()


@contextlib.contextmanager
def attach(parent: Optional[Span]):
    """Re-enter ``parent`` as the current span in THIS thread's context:
    the explicit cross-thread hop (threads do not inherit the spawning
    thread's contextvars)."""
    if parent is None:
        yield
        return
    token = _CURRENT.set(parent)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def _devices(values, out: set) -> set:
    """The devices of every tensor in a nest of lists, tuples and dicts."""
    import torch

    if isinstance(values, torch.Tensor):
        out.add(values.device)
    elif isinstance(values, dict):
        for v in values.values():
            _devices(v, out)
    elif isinstance(values, (list, tuple)):
        for v in values:
            _devices(v, out)
    return out


def _synchronize(values) -> None:
    from fm_returnprediction_tpu_torch.device import synchronize

    for dev in _devices(values, set()):
        synchronize(dev)


def device_sync(values) -> None:
    """Wait for the devices of a stage's output tensors, when
    ``FMRP_SYNC_STAGES=1``, and record the sync point on the current span.

    CUDA work is asynchronous: a stage that only enqueues kernels returns
    before they run, and the next stage that waits absorbs their time.
    Under ``FMRP_SYNC_STAGES=1`` the wait lands in the stage that owns the
    work; with tracing on, the measured wait is a ``device_sync`` event.
    It moves waits between stages and changes no value; on the CPU it
    waits for nothing."""
    synced = os.environ.get("FMRP_SYNC_STAGES", "0") == "1"
    if not synced:
        if _ENABLED:
            event("device_sync", cat="sync", synced=False)
        return
    if not _ENABLED:
        _synchronize(values)
        return
    t0 = time.perf_counter_ns()
    _synchronize(values)
    event("device_sync", cat="sync", synced=True,
          wait_ms=round((time.perf_counter_ns() - t0) / 1e6, 3))


class _TimedBox:
    __slots__ = ("s",)

    def __init__(self) -> None:
        self.s = 0.0


@contextlib.contextmanager
def timed(name: str = "timed", cat: str = "timer", **attrs):
    """Time a block: yields a box whose ``.s`` holds the elapsed seconds on
    exit, and records the block as a span when tracing is armed."""
    box = _TimedBox()
    with span(name, cat=cat, **attrs):
        t0 = time.perf_counter()
        try:
            yield box
        finally:
            box.s = time.perf_counter() - t0


def finished_spans() -> List[Span]:
    """Snapshot of collected (closed) spans, in completion order."""
    with _LOCK:
        return list(_SPANS)


def standalone_events() -> List[dict]:
    """Snapshot of events recorded with no enclosing span."""
    with _LOCK:
        return list(_EVENTS)


def collector_stats() -> dict:
    with _LOCK:
        return {"spans": len(_SPANS), "events": len(_EVENTS), "dropped": _DROPPED}


def reset() -> None:
    """Clear collected spans and events and restart the id sequence."""
    global _IDS, _DROPPED
    with _LOCK:
        _SPANS.clear()
        _EVENTS.clear()
        _DROPPED = 0
        _IDS = itertools.count(1)
