"""End-to-end entry of the port's slice: prepared panel → characteristics →
universes → Table 2.

The entry starts from the prepared inputs — the dense base panel and the
compacted daily strips, both host numpy (``panel.dense.DensePanel``,
``panel.daily.CompactDaily``; ``convert.prepared_from_numpy`` reads them
from other producers) — and everything after runs on the compute device.

    from fm_returnprediction_tpu_torch.pipeline import run_pipeline
    res = run_pipeline(dense_base, compact_daily)            # on the GPU
    res = run_pipeline(dense_base, compact_daily, device="cpu")
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import pandas as pd
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.panel.characteristics import get_factors
from fm_returnprediction_tpu_torch.panel.daily import CompactDaily
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu_torch.reporting.table2 import (
    format_table_2,
    table_2_cells,
)
from fm_returnprediction_tpu_torch.utils.timing import StageTimer

__all__ = ["PipelineResult", "build_panel_prepared", "run_pipeline"]


@dataclasses.dataclass
class PipelineResult:
    panel: DensePanel                       # enriched panel, values on device
    factors_dict: Dict[str, str]
    subset_masks: Dict[str, torch.Tensor]
    table_2: pd.DataFrame                   # formatted reference layout
    table_2_cells: Dict[Tuple[str, str], dict]  # coef/tstat/mean_r2/mean_n
    stage_seconds: Dict[str, float]         # device-synchronized wall time


def build_panel_prepared(
    dense_base: DensePanel,
    compact_daily: CompactDaily,
    dtype: torch.dtype = torch.float32,
    device=None,
    include_turnover: bool = False,
    timer: Optional[StageTimer] = None,
) -> Tuple[DensePanel, Dict[str, str]]:
    """The enriched characteristic panel from the prepared inputs."""
    return get_factors(dense_base, compact_daily, dtype=dtype, device=device,
                       include_turnover=include_turnover, timer=timer)


def run_pipeline(
    dense_base: DensePanel,
    compact_daily: CompactDaily,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    include_turnover: bool = False,
) -> PipelineResult:
    """Characteristics → NYSE-breakpoint universes → Table 2, on ``device``
    (default the GPU; raises when there is none and the CPU was not asked
    for)."""
    device = resolve_device(device)
    timer = StageTimer(device)
    with timer.stage("build_panel"):
        panel, factors_dict = build_panel_prepared(
            dense_base, compact_daily, dtype=dtype, device=device,
            include_turnover=include_turnover, timer=timer,
        )
    with timer.stage("subset_masks"):
        masks = compute_subset_masks(panel)
    with timer.stage("table_2"):
        cells = table_2_cells(panel, masks, factors_dict)
    table_2 = format_table_2(cells, list(masks))
    return PipelineResult(panel, factors_dict, masks, table_2, cells,
                          dict(timer.durations))
