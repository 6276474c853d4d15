"""Data-integrity guard layer of the port.

- ``contracts`` — declarative invariant contracts evaluated at every stage
  boundary of ``run_pipeline`` and the task graph, with a
  ``fail``/``quarantine``/``warn`` severity ladder and the run's
  ``AuditRecord``;
- ``drift`` — tolerance-banded comparison of each persisted artifact with
  the previous run's audit manifest;
- ``checks`` — the numerical sentinels (finite and overflow counters,
  condition taps) queued on the device by the OLS, FM and Gram programs and
  drained once per stage (``FMRP_GUARD``).
"""

from fm_returnprediction_tpu_torch.guard.checks import (
    counters,
    drain,
    guard_active,
    guards,
    reset,
    set_guard,
)
from fm_returnprediction_tpu_torch.guard.contracts import (
    AuditRecord,
    GuardWarning,
    Rule,
    Violation,
    check_frame,
    check_panel,
    cross_section_rules,
    enforce,
    evaluate,
    frame_rules,
    panel_probe,
    panel_rules,
    screen_artifact,
    serving_state_rules,
)
from fm_returnprediction_tpu_torch.guard.drift import (
    DriftBand,
    DriftSentinel,
    compare_summaries,
    summarize_arrays,
    summarize_frame,
)
from fm_returnprediction_tpu_torch.resilience.errors import (
    ContractViolationError,
    DriftDetectedError,
)

__all__ = [
    "AuditRecord",
    "ContractViolationError",
    "DriftBand",
    "DriftDetectedError",
    "DriftSentinel",
    "GuardWarning",
    "Rule",
    "Violation",
    "check_frame",
    "check_panel",
    "compare_summaries",
    "counters",
    "cross_section_rules",
    "drain",
    "enforce",
    "evaluate",
    "frame_rules",
    "guard_active",
    "guards",
    "panel_probe",
    "panel_rules",
    "reset",
    "screen_artifact",
    "serving_state_rules",
    "set_guard",
    "summarize_arrays",
    "summarize_frame",
]
