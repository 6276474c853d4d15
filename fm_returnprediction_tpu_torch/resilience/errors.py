"""The typed failures the guard and resilience layers raise.

The part of the reference package's failure taxonomy that the port uses:
corrupt persisted artifacts, injected faults, contract violations,
quarantined artifacts and drift, an exhausted retry, a stalled serving
dispatch and a killed serving replica. Nothing here imports anything, so
every layer (``utils.cache``, ``data.prepared``, ``resilience.checkpoint``,
``resilience.retry``, ``serving``) can name these types.
"""

from __future__ import annotations

__all__ = [
    "ResilienceError",
    "RetryExhaustedError",
    "DispatchTimeoutError",
    "CorruptArtifactError",
    "IngestRejectedError",
    "ContractViolationError",
    "DriftDetectedError",
    "ReplicaDeadError",
    "InjectedFault",
]


class ResilienceError(RuntimeError):
    """Base class for failures the resilience and guard layers raise."""


class RetryExhaustedError(ResilienceError):
    """A retried call failed on every attempt; ``__cause__`` is the last
    underlying error."""


class DispatchTimeoutError(ResilienceError):
    """A serving bucket dispatch exceeded the executor's watchdog budget.

    Delivered to the in-flight batch's futures so the microbatcher keeps
    draining instead of hanging behind a stalled runner."""


class CorruptArtifactError(ResilienceError):
    """A persisted artifact failed its content checksum or is structurally
    unreadable. The resume paths (the prepared-inputs slot, the stage
    checkpoints) catch it and rebuild the artifact."""


class IngestRejectedError(ResilienceError):
    """An input failed a quarantine-severity contract: the caller drops it
    and continues degraded (``guard.contracts.screen_artifact`` drops the
    optional artifact)."""


class ContractViolationError(ResilienceError):
    """A fail-severity data-integrity contract was breached at a stage
    boundary (``guard.contracts``): the stage's product is structurally or
    numerically wrong (duplicated keys, non-monotone calendar, values in
    overflow territory), so downstream estimates cannot be trusted. The
    message carries every named violation."""


class DriftDetectedError(ContractViolationError):
    """A persisted artifact moved beyond its tolerance band relative to the
    previous run's audit manifest (``guard.drift``). The trusted manifest
    is left unmodified so the regression remains reproducible against it."""


class ReplicaDeadError(ResilienceError):
    """A serving replica was killed (``serving.service.ERService.kill``)
    with this request still queued on it: the request fails with this
    error instead of being stranded."""


class InjectedFault(OSError):
    """The default exception a ``resilience.faults.FaultPlan`` raises at a
    fault site. Subclasses ``OSError`` so an injected fault takes the same
    handler paths a real transient IO error would."""
