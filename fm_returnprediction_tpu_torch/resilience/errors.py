"""The typed failures the guard layer raises.

The part of the reference package's failure taxonomy that the port's
guard layer uses: contract violations, quarantined artifacts and drift.
Nothing here imports anything, so every layer can name these types.
"""

from __future__ import annotations

__all__ = [
    "ResilienceError",
    "IngestRejectedError",
    "ContractViolationError",
    "DriftDetectedError",
]


class ResilienceError(RuntimeError):
    """Base class for failures the resilience and guard layers raise."""


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
