"""Wall-clock stage timing that waits for the device.

PyTorch returns before CUDA work finishes, so a stage's time is taken
after ``torch.cuda.synchronize`` on the stage's device; on the CPU the
wait is a no-op.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from fm_returnprediction_tpu_torch.device import synchronize

__all__ = ["StageTimer"]


class StageTimer:
    """Records seconds per named stage, synchronizing ``device`` at each
    stage's start and end."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        synchronize(self.device)
        start = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.durations[name] = (self.durations.get(name, 0.0)
                                    + time.perf_counter() - start)
