"""Online expected-return serving in one process: the query layer.

The batch pipeline fits once; this package answers queries: a frozen,
cache-serializable ``ServingState`` (lagged rolling-mean coefficients,
featurization constants, additive OLS sufficient statistics per month,
``state``), a thread-safe microbatcher that coalesces single-firm queries
into padded power-of-two buckets (``batcher``), a bucketed executor whose
buckets are warmed CUDA graphs on the card and eager callables on the CPU
(``executor``), the request/response front end with qps, latency,
occupancy and program counters, SLOs and the metrics endpoint
(``service``), and the incremental month ingest (``ingest``).

The reference's fleet tier (``fleet``, ``supervisor``, ``journal``,
``recovery``, ``brownout``, ``loadgen``, the process replicas and the
shared-memory transport) is not ported yet (ROADMAP A6, A8).
"""

from fm_returnprediction_tpu_torch.serving.batcher import MicroBatcher, QueueFullError
from fm_returnprediction_tpu_torch.serving.executor import (
    BucketedExecutor,
    bucket_for,
    bucket_sizes,
)
from fm_returnprediction_tpu_torch.serving.ingest import ingest_month
from fm_returnprediction_tpu_torch.serving.service import ERService
from fm_returnprediction_tpu_torch.serving.state import (
    ServingState,
    build_serving_state,
    build_serving_state_from_panel,
)

__all__ = [
    "ServingState",
    "build_serving_state",
    "build_serving_state_from_panel",
    "MicroBatcher",
    "QueueFullError",
    "BucketedExecutor",
    "bucket_sizes",
    "bucket_for",
    "ERService",
    "ingest_month",
]
