"""Orchestration layer: an incremental task graph and the pipeline DAG.

An in-package engine (sqlite state, content-hash deps, green/SLURM
reporters, retries, timeouts, keep-going) and the Lewellen pipeline as
tasks over the port's modules, with dense-panel and serving-state
checkpoints. ``python -m fm_returnprediction_tpu_torch.taskgraph``.
"""

from fm_returnprediction_tpu_torch.taskgraph.engine import (
    GreenReporter,
    PlainReporter,
    Task,
    TaskRunner,
)
from fm_returnprediction_tpu_torch.taskgraph.tasks import build_tasks

__all__ = [
    "GreenReporter",
    "PlainReporter",
    "Task",
    "TaskRunner",
    "build_tasks",
]
