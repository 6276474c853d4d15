"""Fault-tolerance layer of the port.

- ``retry`` — ``RetryPolicy`` and ``call_with_retry`` (exponential backoff,
  deterministic jitter, an exception allowlist);
- ``checkpoint`` — ``StageCheckpointer``: fingerprint-keyed,
  checksum-verified stage artifacts, so ``run_pipeline`` resumes at the
  last completed stage;
- ``faults`` — ``FaultPlan``/``fault_site``: deterministic fault injection
  at named sites (free when no plan is armed);
- ``errors`` — the typed failures the recovery paths dispatch on.
"""

from fm_returnprediction_tpu_torch.resilience.errors import (
    ContractViolationError,
    CorruptArtifactError,
    DegradedWorldError,
    DispatchTimeoutError,
    DriftDetectedError,
    IngestRejectedError,
    InjectedFault,
    ResilienceError,
    RetryExhaustedError,
    TaskTimeoutError,
)
from fm_returnprediction_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    chaos_env,
    fault_site,
    install_plan_from_env,
    truncate_file,
)
from fm_returnprediction_tpu_torch.resilience.retry import (
    RetryPolicy,
    call_with_retry,
    retrying,
)
from fm_returnprediction_tpu_torch.resilience.checkpoint import StageCheckpointer

__all__ = [
    "ResilienceError",
    "RetryExhaustedError",
    "TaskTimeoutError",
    "DispatchTimeoutError",
    "CorruptArtifactError",
    "IngestRejectedError",
    "ContractViolationError",
    "DriftDetectedError",
    "DegradedWorldError",
    "InjectedFault",
    "FaultPlan",
    "FaultSpec",
    "fault_site",
    "chaos_env",
    "install_plan_from_env",
    "truncate_file",
    "RetryPolicy",
    "call_with_retry",
    "retrying",
    "StageCheckpointer",
]
