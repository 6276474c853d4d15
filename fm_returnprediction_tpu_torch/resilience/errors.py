"""The typed failures the guard and resilience layers raise.

The part of the reference package's failure taxonomy that the port uses:
corrupt persisted artifacts, injected faults, contract violations,
quarantined artifacts and drift, an exhausted retry, a task past its time
budget, a stalled serving dispatch, a killed serving replica, and the
serving fleet's admission shed, crash close-out and aborted rollover.
Nothing here imports anything, so every layer (``utils.cache``,
``data.prepared``, ``resilience.checkpoint``, ``resilience.retry``,
``serving``, ``taskgraph``) can name these types.
"""

from __future__ import annotations

__all__ = [
    "ResilienceError",
    "RetryExhaustedError",
    "TaskTimeoutError",
    "DispatchTimeoutError",
    "CorruptArtifactError",
    "IngestRejectedError",
    "ContractViolationError",
    "DriftDetectedError",
    "ServiceOverloadError",
    "ReplicaDeadError",
    "RecoveredInFlightError",
    "StateRolloverError",
    "InjectedFault",
    "DegradedWorldError",
]


class ResilienceError(RuntimeError):
    """Base class for failures the resilience and guard layers raise."""


class RetryExhaustedError(ResilienceError):
    """A retried call failed on every attempt; ``__cause__`` is the last
    underlying error."""


class TaskTimeoutError(ResilienceError):
    """A task action exceeded its ``timeout_s`` wall-clock budget."""


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


class ServiceOverloadError(ResilienceError):
    """The serving fleet shed this request at admission (429-style).

    RETRIABLE by contract: the request was refused before any replica saw
    it, so a resubmit can never double-serve. Carries the shed decision's
    evidence:

    - ``retry_after_s``: the admission controller's hint for when capacity
      should exist again (token-bucket refill time, or the estimated queue
      drain time);
    - ``reason``: ``"token_bucket"`` | ``"queue_occupancy"`` |
      ``"replica_backpressure"`` | ``"no_healthy_replicas"`` |
      ``"brownout_shed"``;
    - ``queue_depth`` / ``queue_ceiling``: aggregate pending requests vs
      the fleet's total queue capacity at decision time (None when the
      reason carries no queue evidence).
    """

    def __init__(self, message: str, *, retry_after_s: float = 0.0,
                 reason: str = "overload", queue_depth=None, queue_ceiling=None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.reason = str(reason)
        self.queue_depth = queue_depth
        self.queue_ceiling = queue_ceiling

    @property
    def occupancy(self):
        """Queue fill fraction at decision time (None without evidence)."""
        if not self.queue_ceiling:
            return None
        return self.queue_depth / self.queue_ceiling


class ReplicaDeadError(ResilienceError):
    """A serving replica was killed (``serving.service.ERService.kill``)
    with this request still queued on it: the request fails with this
    error instead of being stranded."""


class RecoveredInFlightError(ResilienceError):
    """A request was admitted but still in flight when the fleet process
    died; crash-restart recovery (``serving.recovery``) closed it out with
    this outcome in the journal. RETRIABLE by contract: quoting is
    read-only and the original future died with the process, so a
    resubmit can never double-serve."""


class StateRolloverError(ResilienceError):
    """A fleet-wide state rollover aborted in its PREPARE phase (a failed
    validation, a poisoned candidate, a warm-up error on some replica).
    Nothing has flipped: every replica still serves the previous version.
    The message names the replica and the cause."""


class InjectedFault(OSError):
    """The default exception a ``resilience.faults.FaultPlan`` raises at a
    fault site. Subclasses ``OSError`` so an injected fault takes the same
    handler paths a real transient IO error would."""


class DegradedWorldError(ResilienceError):
    """A grid worker died and the run is configured exact-world-only
    (``FMRP_TOPO_DEGRADED_GRID=0``): the pool refuses the disclosed N−1
    merge rather than serving a partial sum. Carries the dead shard ranks;
    with the knob at its default the pool degrades (exactly, by Gram
    additivity over the survivors) and discloses instead of raising."""

    def __init__(self, message: str, *, dead_ranks=()):
        super().__init__(message)
        self.dead_ranks = tuple(dead_ranks)
