"""Reductions of a ``torch.profiler`` Chrome trace to the benchmark's numbers.

The union of device intervals inside a host window is a frozen copy of the
port's ``telemetry/perf.py::device_busy_share``; the rest (kernel time by
name, the longest idle stretches by the host span they fell in) is the
benchmark's own.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path) -> list:
    with open(path) as fh:
        doc = json.load(fh)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The merged parts of ``intervals`` (sorted) inside [lo, hi]."""
    merged = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class TraceView:
    """A traced stretch: the device activity inside the host annotation
    ``window_name`` (its first occurrence), times in seconds."""

    def __init__(self, events: list, window_name: str):
        wins = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == window_name]
        if not wins:
            raise KeyError(f"no annotation named {window_name!r} in the trace")
        self.lo, self.hi = wins[0]
        self.device = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", ""), e.get("cat"))
                             for e in events
                             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
        self.spans = [(e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in events
                      if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                      and e.get("name") != window_name]
        self.busy = _union([(a, b) for a, b, _, _ in self.device], self.lo, self.hi)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(min(b, self.hi) - max(a, self.lo) for a, b, name, cat in self.device
                   if cat == "kernel" and rx.search(name) and b > self.lo and a < self.hi) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        by = defaultdict(float)
        for a, b, name, cat in self.device:
            if b > self.lo and a < self.hi:
                by[name[:120]] += (min(b, self.hi) - max(a, self.lo)) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_span(self, k: int = 10) -> List[List]:
        """Idle device time inside the window, summed by the innermost host
        span open over each part of it: ``[[span name, seconds], ...]``."""
        gaps, cur = [], self.lo
        for a, b in self.busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < self.hi:
            gaps.append((cur, self.hi))
        # the stretches between span edges, each named by the innermost span
        # open over it; each gap is cut at those edges
        spans = [s for s in self.spans if s[1] > self.lo and s[0] < self.hi]
        edges = sorted({p for lo, hi, _ in spans for p in (lo, hi)} | {self.lo, self.hi})
        names = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            mid = 0.5 * (lo + hi)
            inner: Optional[Tuple[float, str]] = None
            for s_lo, s_hi, name in spans:
                if s_lo <= mid <= s_hi and (inner is None or s_hi - s_lo < inner[0]):
                    inner = (s_hi - s_lo, name)
            names.append(inner[1] if inner else "(benchmark loop)")
        by = defaultdict(float)
        for a, b in gaps:
            i = max(bisect.bisect_right(edges, a) - 1, 0)
            while i < len(names) and edges[i] < b:
                by[names[i]] += (min(b, edges[i + 1]) - max(a, edges[i])) / 1e6
                i += 1
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
