"""Resampling and (later) multi-device parallel paths of the port.

- ``bootstrap`` — the moving-block bootstrap of the monthly slope series
  behind the bootstrap-SE table, on one device.

The mesh and multi-process paths of the reference package are not ported
yet (ROADMAP §A item 8).
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
