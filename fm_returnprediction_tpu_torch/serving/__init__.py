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

Above the single service sits the FLEET tier, in one process: N
supervised thread replicas behind one admission-controlled submit path
(``fleet``: consistent-hash routing, token-bucket and queue-occupancy
shedding with typed retriable 429s, drain-and-replace failover through
the registry warm pool, two-phase state rollover), the supervisor with its
autoscaler leg (``supervisor``), the brownout ladder of disclosed
host-side routes (``brownout``), the write-ahead request journal and its
replay (``journal``), crash-restart recovery (``recovery``), and the load
harness with the capacity model (``loadgen``). Replicas are threads or,
with ``replica_mode="process"``, spawned processes (``replica_proc``,
``replica_worker``) behind a socket or a shared-memory data plane
(``shm``).
"""

from fm_returnprediction_tpu_torch.serving.batcher import MicroBatcher, QueueFullError
from fm_returnprediction_tpu_torch.serving.brownout import (
    BrownoutController,
    BrownoutPolicy,
    DegradedQuote,
)
from fm_returnprediction_tpu_torch.serving.executor import (
    BucketedExecutor,
    bucket_for,
    bucket_sizes,
)
from fm_returnprediction_tpu_torch.serving.fleet import (
    AdmissionPolicy,
    HashRing,
    ServingFleet,
    TokenBucket,
    fleet_smoke,
)
from fm_returnprediction_tpu_torch.serving.ingest import ingest_month
from fm_returnprediction_tpu_torch.serving.journal import (
    JournalReplay,
    RequestJournal,
    replay_journal,
)
from fm_returnprediction_tpu_torch.serving.loadgen import (
    LoadGen,
    LoadPhase,
    capacity_model,
    portfolio_consumer,
    query_with_retry,
)
from fm_returnprediction_tpu_torch.serving.replica_proc import (
    ProcessReplica,
    ReplicaSpawnError,
)
from fm_returnprediction_tpu_torch.serving.recovery import (
    RecoveryReport,
    recover_journal,
    repair_journal,
)
from fm_returnprediction_tpu_torch.serving.service import ERService
from fm_returnprediction_tpu_torch.serving.state import (
    ServingState,
    build_serving_state,
    build_serving_state_from_panel,
)
from fm_returnprediction_tpu_torch.serving.supervisor import (
    AutoscalePolicy,
    HealthPolicy,
    Supervisor,
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
    "ServingFleet",
    "AdmissionPolicy",
    "TokenBucket",
    "HashRing",
    "fleet_smoke",
    "RequestJournal",
    "JournalReplay",
    "replay_journal",
    "Supervisor",
    "HealthPolicy",
    "AutoscalePolicy",
    "BrownoutPolicy",
    "BrownoutController",
    "DegradedQuote",
    "LoadGen",
    "LoadPhase",
    "capacity_model",
    "portfolio_consumer",
    "query_with_retry",
    "RecoveryReport",
    "recover_journal",
    "repair_journal",
    "ProcessReplica",
    "ReplicaSpawnError",
]
