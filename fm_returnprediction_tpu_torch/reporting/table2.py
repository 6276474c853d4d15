"""Table 2 — Fama-MacBeth slopes, t-stats and R² for 3 models × 3 universes.

All nine (model, subset) cells are solved from one shared Gram contraction
(``specgrid.run_spec_grid``), with the batched QR route as the per-cell
referee. Layout and formatting follow the reference:

- rows (Model, Predictor) with an ``N`` row closing each model block;
- columns (subset, {Slope, t-stat, R^2}), subsets in canonical order;
- R² printed only on the first predictor row of each (model, subset) block;
- Slope/t-stat/R² formatted ``%.3f``; N as a comma-separated integer
  (stored in the Slope column);
- remaining NaNs become empty strings.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.models.lewellen import MODELS, model_columns
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.panel.subsets import SUBSET_ORDER
from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid
from fm_returnprediction_tpu_torch.specgrid.specs import table2_grid

__all__ = ["table_2_cells", "format_table_2", "build_table_2"]

# Table 2's FM hyperparameters (NW lag 4, reference weight, 10 months).
TABLE2_NW_LAGS = 4
TABLE2_MIN_MONTHS = 10
TABLE2_WEIGHT = "reference"


def table_2_cells(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    variables_dict: Dict[str, str],
    models: Optional[list] = None,
    return_col: str = "retx",
) -> Dict[Tuple[str, str], dict]:
    """Every Table 2 cell's numbers: ``(model name, subset) → {"coef",
    "tstat", "nw_se", "mean_r2", "mean_n"}`` (host numpy; coef/tstat/nw_se
    in the model's predictor order)."""
    models = models if models is not None else MODELS
    subset_names = list(subset_masks)
    grid = table2_grid(
        variables_dict, models=models, subsets=subset_names,
        nw_lags=TABLE2_NW_LAGS, min_months=TABLE2_MIN_MONTHS,
        weight=TABLE2_WEIGHT,
    )
    y = panel.var(return_col)
    x_all = panel.select(grid.union_predictors)
    res = run_spec_grid(y, x_all, subset_masks, grid)
    cells = {}
    for mi, model in enumerate(models):
        for si, name in enumerate(subset_names):
            fm = res.spec_summary(grid, mi * len(subset_names) + si)
            cells[(model.name, name)] = {
                "coef": np.asarray(fm.coef), "tstat": np.asarray(fm.tstat),
                "nw_se": np.asarray(fm.nw_se), "mean_r2": float(fm.mean_r2), "mean_n": float(fm.mean_n),
            }
    return cells


def format_table_2(cells: Dict[Tuple[str, str], dict], subset_names,
                   models: Optional[list] = None) -> pd.DataFrame:
    """The formatted reference-layout Table 2 frame from the cell numbers."""
    models = models if models is not None else MODELS
    subset_names = list(subset_names)
    rows = []
    for model in models:
        for subset_name in subset_names:
            cell = cells[(model.name, subset_name)]
            for i, label in enumerate(model.predictors):
                rows.append({
                    "Model": model.name, "Predictor": label,
                    "Subset": subset_name, "Slope": cell["coef"][i],
                    "t-stat": cell["tstat"][i], "R^2": cell["mean_r2"],
                })
            rows.append({
                "Model": model.name, "Predictor": "N", "Subset": subset_name,
                "Slope": cell["mean_n"], "t-stat": np.nan, "R^2": np.nan,
            })

    pivot = pd.DataFrame(rows).pivot(
        index=["Model", "Predictor"], columns="Subset",
        values=["Slope", "t-stat", "R^2"],
    )
    pivot = pivot.swaplevel(0, 1, axis=1)
    subset_order = [s for s in SUBSET_ORDER if s in subset_names]
    pivot = pivot.reindex(labels=subset_order, axis=1, level=0)
    pivot = pivot.reindex(labels=["Slope", "t-stat", "R^2"], axis=1, level=1)

    row_order = []
    for model in models:
        row_order.extend((model.name, label) for label in model.predictors)
        row_order.append((model.name, "N"))
    pivot = pivot.reindex(row_order)

    # R² only on the first predictor row of each model block
    for _, group in pivot.groupby(level="Model", sort=False):
        idx = group.index
        if len(idx) > 1:
            for subset in subset_order:
                pivot.loc[idx[1:], (subset, "R^2")] = np.nan

    formatted = pivot.astype(object).copy()
    for row in formatted.index:
        _, predictor = row
        for col in formatted.columns:
            _, metric = col
            value = pivot.loc[row, col]
            if pd.isna(value):
                formatted.loc[row, col] = ""
            elif predictor == "N" and metric == "Slope":
                formatted.loc[row, col] = f"{int(round(float(value))):,.0f}"
            else:
                formatted.loc[row, col] = f"{float(value):.3f}"
    return formatted


def build_table_2(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    variables_dict: Dict[str, str],
    models: Optional[list] = None,
    return_col: str = "retx",
) -> pd.DataFrame:
    """Assemble the formatted reference-layout Table 2."""
    cells = table_2_cells(panel, subset_masks, variables_dict, models=models,
                          return_col=return_col)
    return format_table_2(cells, list(subset_masks), models=models)
