"""The estimator dimension of a spec-grid sweep.

Ported: the value type — ``Estimator``, ``EST_OLS`` (per-month OLS with
the Newey-West tail, every cell's estimator) and the grammar readers
``parse_estimator`` and ``resolve_estimator`` — and the FWL kind's
Gram-stat transform, ``fwl_transform`` over ``masked_psd_solve``, which the
backtest composes (``backtest.paths``). The other kinds (absorbed fixed
effects, IV, pooled) and their SE families parse, but the tile engine
refuses every non-OLS estimator until they are ported (ROADMAP A5).
"""

from fm_returnprediction_tpu_torch.specgrid.estimators.core import (
    EST_OLS,
    ESTIMATOR_KINDS,
    FM_SE_FAMILIES,
    POOLED_SE_FAMILIES,
    Estimator,
    masked_psd_solve,
    parse_estimator,
    resolve_estimator,
)
from fm_returnprediction_tpu_torch.specgrid.estimators.fwl import fwl_transform

__all__ = [
    "EST_OLS",
    "ESTIMATOR_KINDS",
    "FM_SE_FAMILIES",
    "POOLED_SE_FAMILIES",
    "Estimator",
    "fwl_transform",
    "masked_psd_solve",
    "parse_estimator",
    "resolve_estimator",
]
