"""The estimator family of the spec grid: FWL partialling-out, absorbed
fixed effects, IV/2SLS, clustered and pooled SE families, and the
streaming block bootstrap — each a transform of the grid's per-month Gram
sufficient statistics (``estimators.core`` for the design contract).

- ``core``    — ``Estimator``, ``EST_OLS``, the grammar readers
  ``parse_estimator``/``resolve_estimator`` and ``masked_psd_solve``;
- ``fwl``     — the Schur-complement partialling-out;
- ``iv``      — the two-solve 2SLS projection and its raw-regressor R²;
- ``absorb``  — the FE cell contraction and the alternating projections;
- ``cluster`` — the clustered FM tail and the pooled sandwich families;
- ``grid``    — ``run_estimator_grid_weights``, a whole spec grid under
  one kind (the tile engine's estimator route);
- ``stream``  — ``StreamingBootstrap``, Welford/Chan moments over draws.

On the card the family's one kernel is the Gram contraction K2
(``grams.contract_spec_grams``, ``csrc/gram.cu``), with its float32,
float64, bfloat16 and row-weight branches; the transforms, the FE cell
sums and the pooled meats are plain torch, as the reference computes them
outside any Pallas kernel.
"""

from fm_returnprediction_tpu_torch.specgrid.estimators.absorb import (
    absorb_transform,
    contract_absorb_cells,
)
from fm_returnprediction_tpu_torch.specgrid.estimators.cluster import (
    BANK_POOLED_SE,
    PooledResult,
    decentered_stats,
    fm_cluster_summary,
    pooled_fit,
    pooled_panel_meats,
)
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
from fm_returnprediction_tpu_torch.specgrid.estimators.grid import run_estimator_grid_weights
from fm_returnprediction_tpu_torch.specgrid.estimators.iv import iv_r2, iv_transform
from fm_returnprediction_tpu_torch.specgrid.estimators.stream import StreamingBootstrap

__all__ = [
    "ESTIMATOR_KINDS",
    "FM_SE_FAMILIES",
    "POOLED_SE_FAMILIES",
    "BANK_POOLED_SE",
    "Estimator",
    "EST_OLS",
    "parse_estimator",
    "resolve_estimator",
    "masked_psd_solve",
    "fwl_transform",
    "iv_transform",
    "iv_r2",
    "contract_absorb_cells",
    "absorb_transform",
    "fm_cluster_summary",
    "decentered_stats",
    "pooled_fit",
    "pooled_panel_meats",
    "PooledResult",
    "run_estimator_grid_weights",
    "StreamingBootstrap",
]
