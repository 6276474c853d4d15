"""The one-process part of the reference's distributed observability
plane: metric aggregation.

The serving fleet builds a :class:`MetricAggregator` in every replica
mode (``serving.fleet``). A replica in another process ships
delta-encoded registry snapshots (:func:`registry_delta`) and the fleet
folds them under a ``{proc=}`` label; when a proc departs, its monotone
series (``_total``/``_count``/``_sum``/``_bucket``) fold into a
``proc="departed"`` accumulator, so the exported fleet totals never move
backwards across a kill and respawn. Thread replicas share the fleet's
registry and ship nothing, so with them the aggregator stays empty and
its fold is a no-op. Every mutation and read holds
``metrics.SNAPSHOT_LOCK``, the lock the registry flatten and the
Prometheus render take.

The rest of the reference module (trace-context propagation to spawned
children, the peers' clock anchors, the SIGKILL-surviving flight
annexes) serves process replicas, which wait for ROADMAP A8.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from fm_returnprediction_tpu_torch.telemetry import export as _export
from fm_returnprediction_tpu_torch.telemetry import metrics as _metrics

__all__ = [
    "registry_delta",
    "reset_delta_state",
    "metrics_enabled",
    "MetricAggregator",
]

_FALSE = ("0", "off", "false", "no")


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
    """Fold of replica registry deltas into one exposition.

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
