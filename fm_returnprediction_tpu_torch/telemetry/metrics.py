"""Typed metrics registry: counters, gauges, histograms, one per process.

The single process-wide store every layer registers into: the serving
executor's ``hits``/``misses``/``compiles``/``timeouts``, the
microbatcher's request counters and latency histograms, the retry
policy, the guard sentinels and the checkpointer's outcomes. The
existing ``stats()`` dicts stay plain-int views over the same instruments.

Three instrument types, Prometheus-compatible:

- :class:`Counter`: monotonic, ``inc(n)``;
- :class:`Gauge`: a settable value, or a callable sampled at collect time
  (``gauge_fn``: e.g. the nvcc build cache's size);
- :class:`Histogram`: fixed cumulative buckets with sum and count.

Two ownership modes:

- ``registry().counter(name, **labels)`` returns THE shared instrument for
  that (name, labels): process-wide totals (retry attempts, guard
  sentinel trips);
- ``registry().private_counter(name, **labels)`` returns a FRESH
  instrument aggregated under the same family: per-instance counters (one
  executor's cache hits) whose owner reads ``.value`` for its own
  ``stats()``, while the family export sums every live instance plus a
  retained base into which a garbage-collected instance's counts are
  folded (a Prometheus counter never goes backwards because a retired
  executor was dropped).

``to_prometheus()`` renders the registry in Prometheus text exposition
format, byte for byte as the reference package renders the same
instruments. Metrics are always on: an increment is one small lock. (Span
tracing is the part behind ``FMRP_TELEMETRY``: see ``spans``.)

Where the reference reads the persistent XLA compilation cache
(``jax_cache_stats``, the ``fmrp_jax_compile_cache_{entries,bytes}``
gauges), the port reads its own build cache, the nvcc libraries in
``cuda_build.BUILD_DIR`` (``_build/``, one library per kernel source and
flags): :func:`cuda_build_cache_stats` and the
``fmrp_cuda_build_cache_{entries,bytes}`` gauges.

The reference's ``record_trace`` (``fmrp_jit_traces_total``, one count per
jit lowering at its hot-path sites) has no counterpart: eager torch has
no lowering to count. Its contract, "nothing compiles after warm-up",
becomes two facts the port can observe: no nvcc build after the first
(the build cache does not grow: ``telemetry.perf.recompile_watch``), and
no serving bucket capture after ``warmup()``
(``fmrp_serving_executable_compiles_total``).
"""

from __future__ import annotations

import os
import re
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "cuda_build_cache_stats",
    "DEFAULT_LATENCY_BUCKETS",
    "SNAPSHOT_LOCK",
]

# The snapshot lock (re-entrant): every registry-wide read that is
# rendered to a consumer (``to_prometheus``, the exporters'
# ``flat_metrics``, the flight recorder) serializes here, so one render is
# one consistent cut; single increments never take it.
SNAPSHOT_LOCK = threading.RLock()

# seconds — tuned for host-side serving latencies (sub-ms to tens of s)
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter. ``value`` is an exact int when only ints were
    added — the serving ``stats()`` views rely on that."""

    __slots__ = ("_lock", "_cell", "__weakref__")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cell = [0]  # one-element list: outlives the instance via the
        # registry's GC-fold finalizer closure

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._cell[0] += n

    @property
    def value(self):
        return self._cell[0]


class Gauge:
    """Settable point-in-time value; ``fn`` variants are sampled lazily."""

    __slots__ = ("_lock", "_cell", "_fn", "__weakref__")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._lock = threading.Lock()
        self._cell = [0.0]
        self._fn = fn

    def set(self, v) -> None:
        with self._lock:
            self._cell[0] = v

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:  # noqa: BLE001 — a broken probe reads as 0
                return 0.0
        return self._cell[0]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` upper
    bounds, plus ``sum`` and ``count``)."""

    __slots__ = ("_lock", "_cell", "bounds", "__weakref__")

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self._lock = threading.Lock()
        # counts per bucket (+inf last), then sum, then count
        self._cell = [[0] * (len(self.bounds) + 1), 0.0, 0]

    def observe(self, v) -> None:
        v = float(v)
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._cell[0][idx] += 1
            self._cell[1] += v
            self._cell[2] += 1

    @property
    def count(self) -> int:
        return self._cell[2]

    @property
    def sum(self) -> float:
        return self._cell[1]


def _zero_state(kind: str, bounds) -> object:
    if kind == "histogram":
        return [[0] * (len(bounds) + 1), 0.0, 0]
    return [0]


def _fold_state(kind: str, base, cell) -> None:
    """Fold a dead instrument's final cell into the series base (the cell
    outlives its instrument via the finalizer closure)."""
    if kind == "histogram":
        for i, c in enumerate(cell[0]):
            base[0][i] += c
        base[1] += cell[1]
        base[2] += cell[2]
    else:
        base[0] += cell[0]


class _Series:
    """One (family, labelset): retained base + live instruments."""

    __slots__ = ("labels", "base", "instruments", "shared")

    def __init__(self, labels: LabelKey, kind: str, bounds) -> None:
        self.labels = labels
        self.base = _zero_state(kind, bounds)
        self.instruments: List[weakref.ref] = []
        self.shared = None  # the singleton instrument for shared series


class _Family:
    __slots__ = ("name", "kind", "help", "bounds", "series")

    def __init__(self, name, kind, help_, bounds) -> None:
        self.name = name
        self.kind = kind
        self.help = help_
        self.bounds = bounds
        self.series: Dict[LabelKey, _Series] = {}


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    """Coerce to a legal Prometheus metric/label name."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(value: object) -> str:
    """Escape a label VALUE per the Prometheus text exposition format:
    backslash, double-quote and newline must be escaped or a value like
    ``repr(exc)`` containing a quote splits the label set mid-line."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def escape_help(text: str) -> str:
    """Escape a HELP string (backslash and newline only — quotes are
    legal there)."""
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


class MetricsRegistry:
    """Process-wide instrument store with families aggregated for export."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        # default derived gauges: the nvcc build cache, the evidence that
        # no kernel was rebuilt after the first build
        self.gauge_fn(
            "fmrp_cuda_build_cache_entries",
            lambda: cuda_build_cache_stats()["entries"],
            help="files in the nvcc kernel build cache",
        )
        self.gauge_fn(
            "fmrp_cuda_build_cache_bytes",
            lambda: cuda_build_cache_stats()["bytes"],
            help="bytes in the nvcc kernel build cache",
        )

    # -- instrument creation ----------------------------------------------

    def _series(self, name, kind, help_, labels, bounds=None) -> _Series:
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help_, bounds)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            series = fam.series.get(key)
            if series is None:
                series = fam.series[key] = _Series(key, kind, bounds or ())
            return series

    def _new_instrument(self, name, kind, help_, labels, bounds=None):
        series = self._series(name, kind, help_, labels, bounds)
        if kind == "counter":
            inst = Counter()
        elif kind == "gauge":
            inst = Gauge()
        else:
            inst = Histogram(bounds or DEFAULT_LATENCY_BUCKETS)
        with self._lock:
            series.instruments.append(weakref.ref(inst))
            # fold the final counts into the retained base when the owner
            # (a retired executor, a closed batcher) is collected — family
            # totals must never go backwards
            weakref.finalize(inst, _fold_state, kind, series.base, inst._cell)
        return inst, series

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        """THE shared counter for (name, labels) — created once."""
        series = self._series(name, "counter", help, labels)
        with self._lock:
            if series.shared is None:
                series.shared = Counter()
                series.instruments.append(weakref.ref(series.shared))
            return series.shared

    def private_counter(self, name: str, help: str = "", **labels) -> Counter:
        """A fresh counter aggregated under the (name, labels) family —
        per-instance ownership, family-level export."""
        inst, _ = self._new_instrument(name, "counter", help, labels)
        return inst

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        series = self._series(name, "gauge", help, labels)
        with self._lock:
            if series.shared is None:
                series.shared = Gauge()
                series.instruments.append(weakref.ref(series.shared))
            return series.shared

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "", **labels) -> None:
        """Register a derived gauge sampled at collect time."""
        series = self._series(name, "gauge", help, labels)
        g = Gauge(fn=fn)
        with self._lock:
            series.shared = g
            series.instruments.append(weakref.ref(g))

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_LATENCY_BUCKETS, **labels) -> Histogram:
        series = self._series(name, "histogram", help, labels,
                              bounds=tuple(buckets))
        with self._lock:
            if series.shared is None:
                series.shared = Histogram(tuple(buckets))
                series.instruments.append(weakref.ref(series.shared))
            return series.shared

    def private_histogram(self, name: str, help: str = "",
                          buckets=DEFAULT_LATENCY_BUCKETS,
                          **labels) -> Histogram:
        inst, _ = self._new_instrument(
            name, "histogram", help, labels, bounds=tuple(buckets)
        )
        return inst

    # -- collection --------------------------------------------------------

    def _live_instruments(self, series: _Series) -> list:
        """Strong refs to the series' live instruments, PRUNING dead
        weakrefs in place (their counts already folded into the base by
        the finalizer) — a long-lived process creating instruments per
        swap/ingest must not grow every collect() linearly forever."""
        with self._lock:
            live = [(r, r()) for r in series.instruments]
            if any(inst is None for _, inst in live):
                series.instruments[:] = [r for r, inst in live if inst is not None]
        return [inst for _, inst in live if inst is not None]

    def _series_value(self, fam: _Family, series: _Series):
        instruments = self._live_instruments(series)
        if fam.kind == "histogram":
            bounds = fam.bounds or DEFAULT_LATENCY_BUCKETS
            total = _zero_state("histogram", bounds)
            _fold_state("histogram", total, series.base)
            for inst in instruments:
                # fold under the instrument's own lock: a concurrent
                # observe() mutates bucket/sum/count non-atomically, and a
                # torn read would render count ≠ Σ buckets
                with inst._lock:
                    _fold_state("histogram", total, inst._cell)
            return {
                "buckets": list(total[0]),
                "sum": total[1],
                "count": total[2],
            }
        if fam.kind == "gauge":
            # gauges do not sum dead bases; sample the live instruments
            vals = [inst.value for inst in instruments]
            return vals[-1] if vals else 0.0
        total = series.base[0]
        for inst in instruments:
            total += inst._cell[0]
        return total

    def collect(self) -> Dict[str, Dict[LabelKey, object]]:
        """name → {labelkey → value} for every family, under
        :data:`SNAPSHOT_LOCK` for the whole walk."""
        with SNAPSHOT_LOCK:
            return self._collect_locked()

    def _collect_locked(self) -> Dict[str, Dict[LabelKey, object]]:
        with self._lock:
            fams = {
                name: (fam, list(fam.series.items()))
                for name, fam in self._families.items()
            }
        out: Dict[str, Dict[LabelKey, object]] = {}
        for name, (fam, series_items) in fams.items():
            out[name] = {
                key: self._series_value(fam, series)
                for key, series in series_items
            }
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format for every family.

        With a per-process identity armed (``telemetry.identity``), every
        series also carries ``process_index="k"`` so scrapes merged from N
        processes stay attributable; unarmed output has no such label."""
        from fm_returnprediction_tpu_torch.telemetry import identity as _identity

        proc_idx = _identity.process_index()
        lines: List[str] = []
        collected = self.collect()
        with self._lock:
            metas = {
                name: (fam.kind, fam.help, fam.bounds)
                for name, fam in self._families.items()
            }
        for name in sorted(collected):
            kind, help_, bounds = metas[name]
            pname = sanitize(name)
            if help_:
                lines.append(f"# HELP {pname} {escape_help(help_)}")
            lines.append(f"# TYPE {pname} {kind}")
            for key in sorted(collected[name]):
                value = collected[name][key]
                if proc_idx is not None and not any(
                    k == "process_index" for k, _ in key
                ):
                    key = tuple(sorted(
                        (*key, ("process_index", str(proc_idx)))
                    ))
                label_str = ",".join(
                    f'{sanitize(k)}="{escape_label_value(v)}"' for k, v in key
                )
                if kind == "histogram":
                    bnds = list(bounds or DEFAULT_LATENCY_BUCKETS)
                    cum = 0
                    for b, c in zip([*bnds, float("inf")], value["buckets"]):
                        cum += c
                        le = "+Inf" if b == float("inf") else repr(b)
                        extra = f'le="{le}"'
                        ls = f"{label_str},{extra}" if label_str else extra
                        lines.append(f"{pname}_bucket{{{ls}}} {cum}")
                    suffix = f"{{{label_str}}}" if label_str else ""
                    lines.append(f"{pname}_sum{suffix} {value['sum']}")
                    lines.append(f"{pname}_count{suffix} {value['count']}")
                else:
                    suffix = f"{{{label_str}}}" if label_str else ""
                    lines.append(f"{pname}{suffix} {value}")
        return "\n".join(lines) + "\n"


_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def cuda_build_cache_stats(build_dir=None) -> dict:
    """Entry count and bytes of the nvcc build cache (``cuda_build.build_dir()``
    unless ``build_dir`` is given): the regular files only, so a
    subdirectory never counts as an entry without bytes. Zeros when the
    directory does not exist (nothing built yet)."""
    if build_dir is None:
        from fm_returnprediction_tpu_torch import cuda_build

        build_dir = cuda_build.build_dir()
    try:
        files = [p for p in (os.path.join(build_dir, f) for f in os.listdir(build_dir))
                 if os.path.isfile(p)]
        return {"entries": len(files), "bytes": sum(os.path.getsize(p) for p in files)}
    except OSError:
        return {"entries": 0, "bytes": 0}
