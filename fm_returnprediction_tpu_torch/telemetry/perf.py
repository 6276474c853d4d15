"""Performance accounting: the program cost ledger, the profiler capture,
the flight recorder and the rebuild sentinel.

- :class:`CostLedger` / :func:`record_program`: one record per program
  the port builds ahead of its use, today one per serving bucket
  (``serving.executor``): on the card the bucket's CUDA graph, captured
  at warm-up, on the CPU its eager callable. The reference reads XLA's
  ``cost_analysis`` after an AOT compile (``record_compiled``,
  ``timed_aot_compile``); the port has no compiler to ask, so a bucket's
  FLOPs and bytes are worked out from its shapes, and its time is the
  capture's wall time (``compile_s``; ``lower_s`` is 0). Records export
  as ``type: "program"`` JSONL lines, Chrome-trace slices and counter
  tracks, and the ``fmrp_program_*`` metric families. Always on: the cost
  is paid once per program at warm-up, never on the dispatch path.
- :func:`profiling`: a ``torch.profiler`` capture (CPU activities and,
  on the card, CUDA activities) around a region, written as a Chrome
  trace (:data:`PROFILE_TRACE_NAME`) into ``profile_dir``; every armed
  host span inside the region also opens a
  ``torch.profiler.record_function``, so the profile carries the stage
  names. ``run_pipeline(profile_dir=)``, ``--profile-dir`` and
  ``ERService.capture_profile`` wrap it. :func:`profile_kernel_counts`
  and :func:`device_busy_share` read such a trace back.
- :func:`dump_flight`: the flight recorder: the last N spans and events,
  the ledger tail and a metrics snapshot, written to ``flight.json`` in
  the trace directory on a serving quarantine or dispatch timeout.
- :func:`recompile_watch`: diffs the nvcc build cache (``_build/``)
  around a region; growth inside a region declared warm (a kernel rebuilt
  after the first build) counts into ``fmrp_unexpected_recompiles_total``
  and warns, naming the programs the ledger saw built in the window.

The reference's registry fetch and store around an AOT compile
(``_registry_fetch``, ``_registry_store``) have their counterpart in
``cuda_build.build_kernels``, which fetches a kernel library from the
registry before nvcc and records it as a ``cuda_kernel`` program of
provenance ``fetched`` (``built`` after nvcc); :func:`provenance_summary`
reads the builds against the fetches, and the build seconds the fetches
saved, per program from the ledger.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import re
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from fm_returnprediction_tpu_torch.telemetry import metrics as _metrics
from fm_returnprediction_tpu_torch.telemetry import spans as _spans

__all__ = [
    "ProgramRecord",
    "CostLedger",
    "cost_ledger",
    "record_program",
    "provenance_summary",
    "record_runtime",
    "peak_flops_estimate",
    "profiling",
    "profiler_active",
    "profile_kernel_counts",
    "device_busy_share",
    "PROFILE_TRACE_NAME",
    "dump_flight",
    "FLIGHT_NAME",
    "recompile_watch",
    "CacheDelta",
]

FLIGHT_NAME = "flight.json"
PROFILE_TRACE_NAME = "profile_trace.json"

_LEDGER_MAX = int(os.environ.get("FMRP_LEDGER_MAX", "4096"))
_FLIGHT_SPANS = int(os.environ.get("FMRP_FLIGHT_SPANS", "256"))


@dataclasses.dataclass(frozen=True)
class ProgramRecord:
    """One built program's cost accounting (the reference's fields; a
    capture fills ``compile_s``, the analytic fields, and leaves what only
    a compiler reports at None)."""

    program: str  # logical name ("serving_bucket")
    signature: str  # shape/dtype key the program was built for
    fingerprint: str  # short stable hash of (program, signature)
    backend: str  # "cuda" or "cpu"
    lower_s: float
    compile_s: float
    flops: Optional[float]
    bytes_accessed: Optional[float]
    temp_bytes: Optional[int]
    argument_bytes: Optional[int]
    output_bytes: Optional[int]
    generated_code_bytes: Optional[int]
    provenance: str  # "captured" (a CUDA graph) | "eager" (a CPU callable) |
    #                  "built" / "fetched" (a kernel library: nvcc / the registry)
    cache_entries_delta: int
    bucket: Optional[int] = None
    t_ns: int = 0  # perf_counter_ns at record time (epoch-anchorable)
    seq: int = 0
    saved_s: Optional[float] = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["lower_s"] = round(d["lower_s"], 6)
        d["compile_s"] = round(d["compile_s"], 6)
        return d


class CostLedger:
    """Process-wide, bounded, append-only store of :class:`ProgramRecord`."""

    def __init__(self, maxlen: int = _LEDGER_MAX) -> None:
        self._lock = threading.Lock()
        self._records: List[ProgramRecord] = []
        self._maxlen = maxlen
        self._dropped = 0
        self._seq = itertools.count(1)

    def add(self, record: ProgramRecord) -> ProgramRecord:
        record = dataclasses.replace(record, seq=next(self._seq))
        with self._lock:
            if len(self._records) >= self._maxlen:
                # evict the OLDEST: the flight recorder and the rebuild
                # sentinel both read the recent tail
                self._records.pop(0)
                self._dropped += 1
            self._records.append(record)
        return record

    def records(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._records)

    def tail(self, n: int) -> List[ProgramRecord]:
        with self._lock:
            return list(self._records[-n:])

    def since(self, seq: int) -> List[ProgramRecord]:
        """Records added after sequence number ``seq``."""
        with self._lock:
            return [r for r in self._records if r.seq > seq]

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._records[-1].seq if self._records else 0

    def stats(self) -> dict:
        """How many records the ledger holds, and how many it evicted."""
        with self._lock:
            return {"records": len(self._records), "dropped": self._dropped}

    def total(self, field: str, program: Optional[str] = None) -> float:
        """Sum of a numeric field over (optionally one program's) records."""
        out = 0.0
        for r in self.records():
            if program is not None and r.program != program:
                continue
            v = getattr(r, field)
            if v is not None:
                out += v
        return out

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0
            self._seq = itertools.count(1)


_LEDGER: Optional[CostLedger] = None
_LEDGER_LOCK = threading.Lock()


def cost_ledger() -> CostLedger:
    """The process-wide cost ledger (created on first use)."""
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = CostLedger()
    return _LEDGER


def _fingerprint(program: str, signature: str) -> str:
    return hashlib.sha256(f"{program}|{signature}".encode()).hexdigest()[:12]


def provenance_summary(records: Optional[List[ProgramRecord]] = None) -> dict:
    """Per program, over the ledger (or an explicit record window): the
    records by provenance (``built``, ``fetched``, ``captured``,
    ``eager``), the seconds paid building (nvcc builds and graph captures,
    ``build_s``), the seconds paid fetching kernel libraries from the
    registry (``fetch_s``), and the nvcc seconds those fetches did not
    pay (``saved_s``, what each fetched entry cost when it was stored)."""
    out: Dict[str, dict] = {}
    for r in (cost_ledger().records() if records is None else records):
        d = out.setdefault(r.program, {
            "built": 0, "fetched": 0, "captured": 0, "eager": 0,
            "build_s": 0.0, "fetch_s": 0.0, "saved_s": 0.0,
        })
        d[r.provenance] = d.get(r.provenance, 0) + 1
        if r.provenance == "fetched":
            d["fetch_s"] += r.compile_s
            if r.saved_s is not None:
                d["saved_s"] += r.saved_s
        else:
            d["build_s"] += r.compile_s
    return out


def record_program(program: str, signature: str, seconds: float, *, backend: str,
                   flops: Optional[float] = None, bytes_accessed: Optional[float] = None,
                   argument_bytes: Optional[int] = None, output_bytes: Optional[int] = None,
                   bucket: Optional[int] = None,
                   provenance: str = "captured",
                   saved_s: Optional[float] = None) -> ProgramRecord:
    """Account one freshly built program into the ledger, the metrics
    registry and (when tracing is armed) the current span: ``seconds`` is
    the build's wall time (a CUDA graph's capture), the FLOPs and byte
    counts are the caller's analytic ones. A kernel library fetched from
    the registry is recorded with provenance ``fetched`` and ``saved_s``,
    the build seconds its entry cost when it was stored."""
    record = cost_ledger().add(ProgramRecord(
        program=program, signature=signature, fingerprint=_fingerprint(program, signature),
        backend=backend, lower_s=0.0, compile_s=float(seconds),
        flops=float(flops) if flops is not None else None,
        bytes_accessed=float(bytes_accessed) if bytes_accessed is not None else None,
        temp_bytes=None, argument_bytes=argument_bytes, output_bytes=output_bytes,
        generated_code_bytes=None, provenance=provenance, cache_entries_delta=0,
        bucket=bucket, t_ns=time.perf_counter_ns(), saved_s=saved_s,
    ))
    reg = _metrics.registry()
    reg.counter(
        "fmrp_program_compiles_total",
        help="programs built (serving buckets captured), by program and provenance",
        program=program, provenance=provenance,
    ).inc()
    reg.counter(
        "fmrp_program_compile_seconds_total",
        help="wall seconds spent building programs, by program",
        program=program,
    ).inc(record.compile_s)
    if record.flops is not None:
        reg.gauge(
            "fmrp_program_flops",
            help="analytic FLOPs of the last build, by program",
            program=program,
        ).set(record.flops)
    if record.bytes_accessed is not None:
        reg.gauge(
            "fmrp_program_bytes_accessed",
            help="analytic bytes accessed by the last build, by program",
            program=program,
        ).set(record.bytes_accessed)
    _spans.event(
        "program_compiled", cat="compile", program=program,
        fingerprint=record.fingerprint, compile_s=round(record.compile_s, 4),
        provenance=provenance, **({"bucket": bucket} if bucket is not None else {}),
    )
    return record


# -- roofline / achieved FLOPs ----------------------------------------------

#: a rough per-core CPU peak (FMA × vector width × ~3 GHz): the roofline
#: gauge's point is the order of magnitude
_CPU_PEAK_PER_CORE = 48e9
#: published dense peaks by card (NVIDIA's data sheet, the SXM part at its
#: 700 W limit): FP32 and FP64 outside the tensor cores, bf16 on them
_CUDA_PEAKS = {"H100": {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}}


def peak_flops_estimate(dtype: str = "float32") -> float:
    """Peak FLOP/s for the roofline gauge: ``FMRP_PEAK_FLOPS`` when set;
    on a CUDA card named in :data:`_CUDA_PEAKS`, its published peak for
    ``dtype``; otherwise (the CPU, an unknown card) the rough CPU rule,
    cores × 48 GFLOP/s. Never raises."""
    env = os.environ.get("FMRP_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    try:
        import torch

        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
            for card, peaks in _CUDA_PEAKS.items():
                if card in name and dtype in peaks:
                    return peaks[dtype]
    except Exception:  # noqa: BLE001 — an unreadable card takes the CPU rule
        pass
    return (os.cpu_count() or 1) * _CPU_PEAK_PER_CORE


#: published memory rates by card (NVIDIA's data sheet, the SXM part)
_CUDA_BANDWIDTH = {"H100": 3.35e12}


def peak_bandwidth_estimate() -> Optional[float]:
    """Peak device memory rate in bytes/s for a byte roofline: on a CUDA
    card named in :data:`_CUDA_BANDWIDTH`, its published rate; otherwise
    None (no byte roofline on the CPU or an unknown card). Never raises."""
    try:
        import torch

        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
            for card, rate in _CUDA_BANDWIDTH.items():
                if card in name:
                    return rate
    except Exception:  # noqa: BLE001 — an unreadable card has no roofline
        pass
    return None


def record_runtime(program: str, seconds: float, flops: Optional[float] = None) -> dict:
    """Achieved FLOP/s (FLOPs over the measured seconds) and roofline
    utilization for a program; sets the ``fmrp_program_achieved_flops`` and
    ``fmrp_program_roofline_utilization`` gauges and returns the numbers
    (an empty dict when no FLOP count is known or the time is not
    positive). ``flops`` defaults to the ledger's total for ``program``."""
    if flops is None:
        flops = cost_ledger().total("flops", program=program)
    if not flops or seconds <= 0:
        return {}
    achieved = flops / seconds
    peak = peak_flops_estimate()
    util = achieved / peak if peak > 0 else 0.0
    reg = _metrics.registry()
    reg.gauge(
        "fmrp_program_achieved_flops",
        help="ledger FLOPs / measured wall seconds, by program",
        program=program,
    ).set(achieved)
    reg.gauge(
        "fmrp_program_roofline_utilization",
        help="achieved FLOP/s over the (rough) platform peak",
        program=program,
    ).set(util)
    return {"achieved_flops": achieved, "peak_flops_estimate": peak,
            "roofline_utilization": util}


# -- profiler capture --------------------------------------------------------

#: Chrome-trace categories of device work in a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler_active() -> bool:
    return _spans.annotation_factory() is not None


def _trace_events(trace) -> list:
    doc = json.loads(Path(trace).read_text()) if not isinstance(trace, dict) else trace
    return doc.get("traceEvents", [])


@contextlib.contextmanager
def profiling(profile_dir=None, device=None):
    """Wrap a region in a ``torch.profiler`` capture written to
    ``profile_dir/profile_trace.json`` (a pass-through when None).

    ``device`` (``None`` = the GPU; raises without one) picks the
    activities: the CPU's always, and on a CUDA device the card's through
    CUPTI. A CUDA capture never drops to CPU-only activities: it raises
    before the region when the profiler cannot trace the card, and after
    it when the trace holds no device activity. Every armed host span in
    the region also opens a ``torch.profiler.record_function`` of its name
    (the capture arms span collection for the region). One capture per
    process: nesting raises."""
    if profile_dir is None:
        yield None
        return
    from fm_returnprediction_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if profiler_active():
        raise RuntimeError("a torch.profiler capture is already active in this process; "
                           "stop it before starting another")
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot trace the CUDA device here "
                               "(no CUPTI); refusing a CPU-only capture of a GPU run")
        activities.append(ProfilerActivity.CUDA)
    profile_dir = Path(profile_dir)
    profile_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _spans.set_annotation_factory(record_function)
    ok = False
    try:
        with _spans.enabled(True):
            yield str(profile_dir)
        ok = True
    finally:
        _spans.set_annotation_factory(None)
        prof.stop()
        path = profile_dir / PROFILE_TRACE_NAME
        prof.export_chrome_trace(str(path))
    if ok and device.type == "cuda" and not any(
            e.get("cat") in DEVICE_CATEGORIES for e in _trace_events(path)):
        raise RuntimeError(f"the profile {path} holds no device activity: the card "
                           "was not traced")


def profile_kernel_counts(trace, patterns: Dict[str, str]) -> Dict[str, int]:
    """Device kernel launches in a profiler trace (a path or a loaded
    document) whose name matches each regex of ``patterns`` (label →
    pattern)."""
    kernels = [e["name"] for e in _trace_events(trace)
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return {label: sum(1 for name in kernels if re.search(pat, name))
            for label, pat in patterns.items()}


def device_busy_share(trace, window_name: str) -> Tuple[float, float, int]:
    """The device's busy share inside the host interval of the
    ``record_function`` named ``window_name`` (a span or stage name; its
    intervals summed when it ran more than once): the union of the device
    activity (kernels, copies, sets) inside the window over the window's
    length. Returns ``(share, window_s, n_windows)``."""
    events = _trace_events(trace)
    windows = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e.get("name") == window_name)
    if not windows:
        raise KeyError(f"no annotation named {window_name!r} in the profile")
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    covered = 0.0
    total = 0.0
    for lo, hi in windows:
        total += hi - lo
        cur_lo = cur_hi = None
        for b_lo, b_hi in busy:
            b_lo, b_hi = max(b_lo, lo), min(b_hi, hi)
            if b_hi <= b_lo:
                continue
            if cur_hi is None or b_lo > cur_hi:
                if cur_hi is not None:
                    covered += cur_hi - cur_lo
                cur_lo, cur_hi = b_lo, b_hi
            else:
                cur_hi = max(cur_hi, b_hi)
        if cur_hi is not None:
            covered += cur_hi - cur_lo
    return (covered / total if total > 0 else 0.0), total / 1e6, len(windows)


# -- flight recorder ---------------------------------------------------------


def flight_snapshot(reason: str, max_spans: int = _FLIGHT_SPANS) -> dict:
    """The flight-recorder payload: the last ``max_spans`` collected spans
    and events, the ledger tail and a metrics snapshot."""
    from fm_returnprediction_tpu_torch.telemetry import export as _export

    cur = _spans.current_span()
    spans = _spans.finished_spans()[-max_spans:]
    events = _spans.standalone_events()[-max_spans:]
    return {
        "type": "flight",
        "schema": 1,
        "reason": reason,
        "pid": os.getpid(),
        "anchor_span_id": cur.span_id if cur is not None else None,
        "collector": _spans.collector_stats(),
        "spans": [_export.span_record(s) for s in spans],
        "events": [_export.event_record(e) for e in events],
        "programs": [r.to_json() for r in cost_ledger().tail(max_spans)],
        "metrics": _export.flat_metrics(),
    }


def dump_flight(reason: str, directory=None) -> Optional[Path]:
    """Write ``flight.json`` (see :func:`flight_snapshot`) into
    ``directory`` (default: the configured trace directory). A no-op
    returning None when no directory is armed; never raises: it runs on
    failure paths whose own exception must stay the one reported."""
    directory = directory or _spans.trace_dir()
    if directory is None:
        return None
    try:
        path = Path(directory) / FLIGHT_NAME
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
        tmp.write_text(json.dumps(flight_snapshot(reason), sort_keys=True, default=repr))
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — see docstring
        return None


# -- rebuild sentinel ---------------------------------------------------------


@dataclasses.dataclass
class CacheDelta:
    """Filled in when a :func:`recompile_watch` region exits."""

    label: str
    warm: bool
    entries_before: int = 0
    entries_after: int = 0
    culprits: Tuple[str, ...] = ()

    @property
    def grew(self) -> int:
        return max(0, self.entries_after - self.entries_before)


@contextlib.contextmanager
def recompile_watch(label: str, warm: bool = False):
    """Diff the nvcc build cache around a region.

    Yields a :class:`CacheDelta`. Growth inside a region declared ``warm``
    means a kernel was rebuilt that a warm run should have reused: it
    counts into ``fmrp_unexpected_recompiles_total{section=}`` and warns
    (never fails), naming the programs the cost ledger saw built inside the
    window."""
    delta = CacheDelta(label=label, warm=warm)
    delta.entries_before = _metrics.cuda_build_cache_stats()["entries"]
    ledger_mark = cost_ledger().last_seq
    try:
        yield delta
    finally:
        delta.entries_after = _metrics.cuda_build_cache_stats()["entries"]
        delta.culprits = tuple(f"{r.program}@{r.fingerprint}"
                               for r in cost_ledger().since(ledger_mark))
        if delta.grew and warm:
            _metrics.registry().counter(
                "fmrp_unexpected_recompiles_total",
                help="build-cache growth observed during warm regions",
                section=label,
            ).inc(delta.grew)
            _spans.event(
                "unexpected_recompile", cat="compile", section=label, grew=delta.grew,
                culprits=",".join(delta.culprits) or "unknown",
            )
            warnings.warn(
                f"warm region {label!r} grew the nvcc build cache by {delta.grew} "
                f"entr{'y' if delta.grew == 1 else 'ies'} (a kernel was rebuilt that "
                "should have been reused); "
                + (f"programs built in the window: {', '.join(delta.culprits)}"
                   if delta.culprits else "the cost ledger saw no program built in "
                   "this window"),
                stacklevel=3,
            )
