"""Telemetry of the port: structured spans, a metrics registry, trace and
profile export.

- :mod:`.spans`: nested, context-propagated host spans with explicit
  cross-thread hand-off (``capture``/``attach``), point events, and the
  ``device_sync`` barrier. ``utils.timing.StageTimer`` opens a ``stage``
  span per stage; ``run_pipeline``, retry attempts, checkpoint loads, the
  spec-grid tiles and the serving request → batch → dispatch chain emit
  them.
- :mod:`.metrics`: counters, gauges and histograms in one process-wide
  registry (serving, retry, guard sentinels, checkpoints, spec-grid
  cells, the nvcc build cache); the ``stats()`` dicts read the same
  instruments.
- :mod:`.export`: the JSONL event log and the Chrome trace
  (Perfetto-loadable, epoch-anchored), and Prometheus text for the
  ``ERService`` metrics endpoint.
- :mod:`.perf`: the program cost ledger (serving bucket captures with
  analytic FLOPs and bytes), the ``torch.profiler`` capture
  (``run_pipeline(profile_dir=)``, ``--profile-dir``,
  ``ERService.capture_profile``) and its readers, the ``flight.json``
  recorder, and the build-cache sentinel.
- :mod:`.slo`: declarative objectives and a sliding-window burn-rate
  monitor over the serving metrics.
- :mod:`.regress`: the perf-regression sentinel over ``BENCH_*.json``
  (``python -m fm_returnprediction_tpu_torch.telemetry.regress``).

Tracing off (the default) costs one global read per instrumented site
and changes nothing; on, it changes no number either: spans are host
records only, so a traced run's artifacts are bit-identical to an
untraced run's, with the same kernel launches.

Knobs: ``FMRP_TELEMETRY=1`` arms span collection; ``FMRP_TRACE_DIR=<dir>``
(or ``run_pipeline(trace_dir=...)`` / ``--trace-dir``) arms it AND exports
``events.jsonl`` and ``trace.json`` there on flush and at exit.

What the reference's ``telemetry`` exports and the port leaves out, with
the reason: ``jax_cache_stats`` (the XLA compilation cache; the port's
counterpart is ``cuda_build_cache_stats``), ``record_trace`` (a jit
lowering count: eager torch has none, see ``metrics``),
``record_compiled`` and ``timed_aot_compile`` (XLA's AOT compile and cost
analysis; the port records a bucket capture with ``record_program``).
``distributed`` carries trace context, clock anchors, metric deltas and
flight annexes across processes; ``timeline`` merges the per-process
exports into one timeline with a per-hop latency table.
"""

from __future__ import annotations

import atexit
import contextlib
from typing import Optional

from fm_returnprediction_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    cuda_build_cache_stats,
    registry,
)
from fm_returnprediction_tpu_torch.telemetry.perf import (
    CostLedger,
    ProgramRecord,
    cost_ledger,
    dump_flight,
    peak_bandwidth_estimate,
    peak_flops_estimate,
    profiling,
    recompile_watch,
    record_program,
    record_runtime,
)
from fm_returnprediction_tpu_torch.telemetry.slo import SLO, SloMonitor, slos_from_env
from fm_returnprediction_tpu_torch.telemetry.spans import (
    Span,
    active,
    attach,
    capture,
    collector_stats,
    current_span,
    device_sync,
    enabled,
    event,
    finished_spans,
    record_span,
    reset,
    set_enabled,
    set_trace_dir,
    span,
    standalone_events,
    timed,
    trace_dir,
)

__all__ = [
    "CostLedger",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ProgramRecord",
    "SLO",
    "SloMonitor",
    "Span",
    "cost_ledger",
    "dump_flight",
    "peak_bandwidth_estimate",
    "peak_flops_estimate",
    "profiling",
    "recompile_watch",
    "record_program",
    "record_runtime",
    "slos_from_env",
    "active",
    "attach",
    "capture",
    "collector_stats",
    "current_span",
    "cuda_build_cache_stats",
    "device_sync",
    "enabled",
    "event",
    "finished_spans",
    "flush",
    "prometheus_text",
    "record_span",
    "registry",
    "reset",
    "set_enabled",
    "set_trace_dir",
    "span",
    "standalone_events",
    "timed",
    "trace_dir",
    "tracing",
]


def prometheus_text(extra=None, extra_prefix: str = "") -> str:
    """Registry (+ optional extra gauges) in Prometheus text format."""
    from fm_returnprediction_tpu_torch.telemetry import export

    return export.prometheus_text(extra=extra, extra_prefix=extra_prefix)


def flush() -> Optional[tuple]:
    """Export the collector to the configured trace directory
    (``events.jsonl`` and ``trace.json``); a no-op returning None when no
    directory is armed. Whole-file rewrites: each flush extends the
    artifact with whatever ran since the last one."""
    directory = trace_dir()
    if directory is None:
        return None
    from fm_returnprediction_tpu_torch.telemetry import export

    return export.export_all(directory)


@contextlib.contextmanager
def tracing(directory=None):
    """Arm tracing for a block and flush the exports on exit.

    ``directory`` (or, when None, the ambient ``FMRP_TRACE_DIR``) becomes
    the export sink. With neither set and tracing not otherwise enabled
    this is a pass-through: ``run_pipeline`` wraps its whole body in it."""
    prev_dir = trace_dir()
    directory = directory or prev_dir
    if directory is None and not active():
        yield
        return
    if directory is not None:
        set_trace_dir(directory)
    with enabled(True):
        try:
            yield
        finally:
            flush()
            # restore: one traced run must not leave tracing armed (and its
            # export directory targeted) for every later run in the process
            set_trace_dir(prev_dir)


@atexit.register
def _flush_at_exit() -> None:  # pragma: no cover - interpreter shutdown
    try:
        flush()
    except Exception:  # noqa: BLE001 — never fail shutdown over telemetry
        pass
