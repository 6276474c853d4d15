"""Resampling and multi-process paths of the port.

- ``bootstrap`` — the moving-block bootstrap of the monthly slope series
  behind the bootstrap-SE table, on one device.
- ``distributed`` — the multi-process bootstrap and the host exchange
  (TCP allgather, rank-ordered ``sum_tree``).
- ``shm`` — shared-memory frame rings and mapped array segments.

The device mesh of the reference package is not ported yet (ROADMAP A8b).
"""

from fm_returnprediction_tpu_torch.parallel.bootstrap import (
    BootstrapResult,
    block_bootstrap_se,
    bootstrap_replicate_means,
    draw_block_starts,
    replicate_means_from_starts,
)

__all__ = [
    "BootstrapResult",
    "block_bootstrap_se",
    "bootstrap_replicate_means",
    "draw_block_starts",
    "replicate_means_from_starts",
]
