"""Wall-clock stage timing that waits for the device.

PyTorch returns before CUDA work finishes, so a stage's time is taken
after ``torch.cuda.synchronize`` on the stage's device, at the stage's
start and at its end; on the CPU the wait is a no-op.

Naming convention (the reference package's, validated by
:meth:`StageTimer.total`): a name with a ``"/"`` is a nested sub-stage
(``build_panel/save_prepared``, ``panel/monthly_ingest``,
``factors/daily_kernels``) whose seconds are already inside the enclosing
top-level stage; a name without one is a top-level stage and must not be
opened while another stage is open. A stage that deliberately did not run
(a checkpoint hit) is marked with :meth:`StageTimer.mark_skipped` and has
no duration, so it never reads as "ran in 0.0 s".

``stage(name)`` times a block on the module's global timer, which waits
for no device (pass ``timer=`` a ``StageTimer`` of the device to time
device work), and ``StageTimer.dump`` writes ``durations`` as JSON.
``trace(log_dir)`` wraps a region in a ``torch.profiler`` capture.

With tracing armed (``telemetry``), each stage is also a host span of
category ``stage``, opened before the start synchronize and closed after
the end one, so a trace and ``durations`` read the same clock; a skipped
stage is a ``stage.skipped`` event.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

from fm_returnprediction_tpu_torch.device import synchronize
from fm_returnprediction_tpu_torch.telemetry import spans as _spans

__all__ = ["StageTimer", "stage", "trace"]


class StageTimer:
    """Records seconds per named stage, synchronizing ``device`` at each
    stage's start and end, and the stages skipped with their reasons."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.durations: Dict[str, float] = {}
        self.skipped: Dict[str, str] = {}
        self._stack: List[str] = []
        self._uncovered: set = set()  # "/"-names closed with no parent open
        self._shadowed: set = set()   # top-level names closed under a parent

    @contextlib.contextmanager
    def stage(self, name: str):
        nested = bool(self._stack)
        self._stack.append(name)
        with _spans.span(name, cat="stage"):
            synchronize(self.device)
            start = time.perf_counter()
            try:
                yield
            finally:
                synchronize(self.device)
                self._stack.pop()
                self.skipped.pop(name, None)  # it ran after all
                self.durations[name] = (self.durations.get(name, 0.0)
                                        + time.perf_counter() - start)
                if "/" in name and not nested:
                    self._uncovered.add(name)
                elif "/" not in name and nested:
                    self._shadowed.add(name)

    @contextlib.contextmanager
    def ensure_stage(self, name: str):
        """Open ``name`` only when no stage is open: for helpers that record
        ``"/"``-nested sub-stages and run both under a caller's stage and
        on their own."""
        if self._stack:
            yield
            return
        with self.stage(name):
            yield

    def mark_skipped(self, name: str, reason: str) -> None:
        """Record that stage ``name`` deliberately did not run, and why. It
        gets no duration; a stage that runs later clears the mark."""
        self.skipped[name] = reason
        _spans.event("stage.skipped", cat="stage", stage=name, reason=reason)

    def total(self) -> float:
        """The sum of the top-level stages. Raises ``ValueError`` when a
        nested name was recorded with no parent open (its seconds would be
        in no top-level stage) or a top-level name inside another stage
        (its seconds would count twice)."""
        if self._uncovered or self._shadowed:
            problems = []
            if self._uncovered:
                problems.append("nested ('/') stages recorded with no parent stage open: "
                                f"{sorted(self._uncovered)}")
            if self._shadowed:
                problems.append("top-level stages recorded inside another stage: "
                                f"{sorted(self._shadowed)}")
            raise ValueError("StageTimer.total(): stage nesting convention violated — "
                             + "; ".join(problems))
        return sum(v for k, v in self.durations.items() if "/" not in k)

    def dump(self, path) -> None:
        """Write ``durations`` as JSON to ``path``, creating its directory."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.durations, indent=2))

    def report(self) -> str:
        """One line per stage (``name  seconds``), one per skipped stage
        (``name  skipped (reason)``), and the total."""
        names = list(self.durations) + list(self.skipped) + ["TOTAL"]
        width = max(len(n) for n in names)
        lines = [f"{name:<{width}}  {secs:9.3f}s" for name, secs in self.durations.items()]
        lines += [f"{name:<{width}}  skipped ({reason})" for name, reason in self.skipped.items()]
        lines.append(f"{'TOTAL':<{width}}  {self.total():9.3f}s")
        return "\n".join(lines)


_GLOBAL_TIMER = StageTimer("cpu")


@contextlib.contextmanager
def stage(name: str, timer: Optional[StageTimer] = None) -> Iterator[None]:
    """Time a block as stage ``name`` on ``timer``, else on the global
    timer (a CPU timer: it waits for no device)."""
    with (timer or _GLOBAL_TIMER).stage(name):
        yield


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device=None) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` capture written under
    ``log_dir`` (``telemetry.perf.profiling``: the CPU's activities and, on
    a CUDA ``device``, the card's); a pass-through when ``log_dir`` is
    None. The task graph's ``FMRP_TRACE=<dir>`` wrapper of its compute
    tasks."""
    if log_dir is None:
        yield
        return
    from fm_returnprediction_tpu_torch.telemetry.perf import profiling

    with profiling(log_dir, device=device):
        yield
