"""The estimator dimension of a spec-grid sweep.

Only the value type is ported: ``Estimator``, ``EST_OLS`` (per-month OLS
with the Newey-West tail, every cell's estimator) and the grammar readers
``parse_estimator`` and ``resolve_estimator``. The other kinds (FWL,
absorbed fixed effects, IV, pooled) and their SE families parse, but the
tile engine refuses them until they are ported (ROADMAP A5).
"""

from fm_returnprediction_tpu_torch.specgrid.estimators.core import (
    EST_OLS,
    ESTIMATOR_KINDS,
    FM_SE_FAMILIES,
    POOLED_SE_FAMILIES,
    Estimator,
    parse_estimator,
    resolve_estimator,
)

__all__ = [
    "EST_OLS",
    "ESTIMATOR_KINDS",
    "FM_SE_FAMILIES",
    "POOLED_SE_FAMILIES",
    "Estimator",
    "parse_estimator",
    "resolve_estimator",
]
