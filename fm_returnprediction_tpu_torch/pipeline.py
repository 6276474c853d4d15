"""End-to-end entry of the port's slices: prepared panel → characteristics →
universes → Table 1 → Table 2 → the figure/decile sweep → Figure 1's
rolling slopes → the decile table → the serving state.

The entry starts from the prepared inputs — the dense base panel and the
compacted daily strips, both host numpy (``panel.dense.DensePanel``,
``panel.daily.CompactDaily``; ``convert.prepared_from_numpy`` reads them
from other producers) — and everything after runs on the compute device.

    from fm_returnprediction_tpu_torch.pipeline import run_pipeline
    res = run_pipeline(dense_base, compact_daily)            # on the GPU
    res = run_pipeline(dense_base, compact_daily, device="cpu")

Figure 1 is returned as the rolling-slope frames it plots
(``PipelineResult.figure_1``); drawing them needs matplotlib
(``reporting.figure1.create_figure_1``), which the pipeline does not import.
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
from fm_returnprediction_tpu_torch.reporting.deciles import build_decile_table
from fm_returnprediction_tpu_torch.reporting.figure1 import (
    SubsetSweepEntry,
    figure_frames,
    subset_sweep,
)
from fm_returnprediction_tpu_torch.reporting.table1 import build_table_1
from fm_returnprediction_tpu_torch.reporting.table2 import (
    format_table_2,
    table_2_cells,
)
from fm_returnprediction_tpu_torch.serving.state import (
    ServingState,
    build_serving_state_from_panel,
)
from fm_returnprediction_tpu_torch.utils.timing import StageTimer

__all__ = ["PipelineResult", "build_panel_prepared", "run_pipeline"]


@dataclasses.dataclass
class PipelineResult:
    panel: DensePanel                       # enriched panel, values on device
    factors_dict: Dict[str, str]
    subset_masks: Dict[str, torch.Tensor]
    table_1: pd.DataFrame                   # (subset, {Avg, Std, N}) columns
    table_2: pd.DataFrame                   # formatted reference layout
    table_2_cells: Dict[Tuple[str, str], dict]  # coef/tstat/mean_r2/mean_n
    sweep: Dict[str, SubsetSweepEntry]      # the figure/decile sweep's subsets
    figure_1: Optional[Dict[str, pd.DataFrame]]  # subset → rolling slopes
    decile_table: Optional[pd.DataFrame]
    serving_state: Optional[ServingState]
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
    make_figure: bool = True,
    make_deciles: bool = True,
    make_serving: bool = True,
) -> PipelineResult:
    """Characteristics → NYSE-breakpoint universes → Table 1 → Table 2 →
    Figure 1 / deciles → serving state, on ``device`` (default the GPU;
    raises when there is none and the CPU was not asked for)."""
    device = resolve_device(device)
    timer = StageTimer(device)
    with timer.stage("build_panel"):
        panel, factors_dict = build_panel_prepared(
            dense_base, compact_daily, dtype=dtype, device=device,
            include_turnover=include_turnover, timer=timer,
        )
    with timer.stage("subset_masks"):
        masks = compute_subset_masks(panel)
    with timer.stage("table_1"):
        table_1 = build_table_1(panel, masks, factors_dict)
    with timer.stage("table_2"):
        cells = table_2_cells(panel, masks, factors_dict)
    table_2 = format_table_2(cells, list(masks))

    # The figure, the decile table and the serving state share one sweep:
    # one Gram contraction gives every subset's figure cross-sections.
    # Without the decile table only the figure's two subsets are swept.
    sweep = {}
    if make_figure or make_deciles:
        with timer.stage("figure_cs"):
            needed = set(masks) if make_deciles else {"All stocks", "Large stocks"}
            sweep = subset_sweep(panel, masks, [n for n in masks if n in needed],
                                 make_deciles=make_deciles)
    figure_1 = None
    if make_figure:
        with timer.stage("figure_1"):
            figure_1 = figure_frames(panel, masks, sweep)
    decile_table = None
    if make_deciles:
        with timer.stage("decile_table"):
            decile_table = build_decile_table(panel, masks, cs_cache=sweep)
    serving_state = None
    if make_serving and "All stocks" in masks:
        with timer.stage("serving_state"):
            entry = sweep.get("All stocks")
            serving_state = build_serving_state_from_panel(
                panel, masks["All stocks"],
                cs=entry.cs if entry is not None else None)
    return PipelineResult(
        panel=panel, factors_dict=factors_dict, subset_masks=masks,
        table_1=table_1, table_2=table_2, table_2_cells=cells, sweep=sweep,
        figure_1=figure_1, decile_table=decile_table,
        serving_state=serving_state, stage_seconds=dict(timer.durations),
    )
