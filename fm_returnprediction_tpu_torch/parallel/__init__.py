"""Resampling, multi-process and device-mesh paths of the port.

- ``bootstrap`` — the moving-block bootstrap of the monthly slope series
  behind the bootstrap-SE table, on one device or with its replicates
  sharded over a mesh.
- ``distributed`` — the multi-process bootstrap and the host exchange
  (TCP allgather, rank-ordered ``sum_tree``).
- ``shm`` — shared-memory frame rings and mapped array segments.
- ``mesh`` — the device mesh, placement, and the deterministic
  collectives; ``partition`` — the declarative partition rule tables.
- ``fm_sharded`` — firm-sharded Fama-MacBeth (distributed TSQR);
  ``daily_sharded`` — firm-sharded daily kernels; ``time_sharded`` —
  rolling reductions over a sharded time axis.
- ``multihost`` — ``torch.distributed`` bring-up and the months × firms
  hierarchy across processes.
"""

from fm_returnprediction_tpu_torch.parallel.bootstrap import (
    BootstrapResult,
    block_bootstrap_se,
    bootstrap_replicate_means,
    draw_block_starts,
    replicate_means_from_starts,
)
from fm_returnprediction_tpu_torch.parallel.daily_sharded import (
    daily_characteristics_sharded,
)
from fm_returnprediction_tpu_torch.parallel.distributed import (
    DistConfig,
    HostExchange,
    dist_active,
    host_exchange,
    initialize_distributed,
    shutdown_distributed,
)
from fm_returnprediction_tpu_torch.parallel.fm_sharded import (
    fama_macbeth_sharded,
    monthly_cs_ols_sharded,
)
from fm_returnprediction_tpu_torch.parallel.mesh import (
    default_mesh,
    host_local_mesh,
    local_devices,
    make_mesh,
    pad_to_multiple,
    pipeline_mesh,
    place_global,
    shard_panel,
)
from fm_returnprediction_tpu_torch.parallel.multihost import (
    as_flat_mesh,
    fama_macbeth_hier,
    initialize_multihost,
    make_mesh_2d,
)
from fm_returnprediction_tpu_torch.parallel.time_sharded import (
    rolling_mean_time_sharded,
    rolling_moments_time_sharded,
    rolling_std_time_sharded,
    rolling_sum_time_sharded,
    weekly_rolling_beta_time_sharded,
)

__all__ = [
    "BootstrapResult",
    "DistConfig",
    "HostExchange",
    "as_flat_mesh",
    "block_bootstrap_se",
    "bootstrap_replicate_means",
    "daily_characteristics_sharded",
    "default_mesh",
    "dist_active",
    "draw_block_starts",
    "fama_macbeth_hier",
    "fama_macbeth_sharded",
    "host_exchange",
    "host_local_mesh",
    "initialize_distributed",
    "initialize_multihost",
    "local_devices",
    "make_mesh",
    "make_mesh_2d",
    "monthly_cs_ols_sharded",
    "pad_to_multiple",
    "pipeline_mesh",
    "place_global",
    "replicate_means_from_starts",
    "rolling_mean_time_sharded",
    "rolling_moments_time_sharded",
    "rolling_std_time_sharded",
    "rolling_sum_time_sharded",
    "shard_panel",
    "shutdown_distributed",
    "weekly_rolling_beta_time_sharded",
]
