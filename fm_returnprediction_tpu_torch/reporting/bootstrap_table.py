"""Bootstrap standard-error table: BASELINE.json configs[4] as an artifact.

The reference reports only analytic Newey-West t-statistics. This table
adds, per (model, subset, predictor), the FM coefficient, the moving-block
bootstrap SE of its mean (``parallel.bootstrap``, B replicates of the
monthly slope series), the bootstrap t, and the analytic NW t beside it.
It is kept out of Table 2 (whose columns the reference's layout fixes to
{Slope, t-stat, R^2}) and goes to its own files, ``bootstrap_se.pkl`` and
``bootstrap_se.tex``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.models.lewellen import MODELS, model_columns
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.panel.subsets import SUBSET_ORDER
from fm_returnprediction_tpu_torch.parallel.bootstrap import block_bootstrap_se
from fm_returnprediction_tpu_torch.reporting.table2 import TABLE2_NW_LAGS

__all__ = ["build_bootstrap_table", "save_bootstrap_table"]

COLUMNS = ["Slope", "Boot SE", "t (boot)", "t (NW)"]


def build_bootstrap_table(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    variables_dict: Dict[str, str],
    n_replicates: int = 10_000,
    block_length: int = TABLE2_NW_LAGS + 1,
    seed: int = 0,
    models: Optional[list] = None,
    mesh=None,
    return_col: str = "retx",
) -> pd.DataFrame:
    """Per (model, subset, predictor): coef, bootstrap SE and t, NW t.

    Rows (Model, Predictor); columns (Subset × {Slope, Boot SE, t (boot),
    t (NW)}). Each cell's slopes come from the QR ``fama_macbeth`` on the
    panel's device, and every cell draws its starts from ``seed``, so the
    table is deterministic in it. With a 1-D ``mesh`` (the pipeline flattens
    its mesh to the ``"boot"`` axis) each cell's replicates shard over it.
    """
    models = models if models is not None else MODELS
    subset_names = [s for s in SUBSET_ORDER if s in subset_masks]
    y = panel.var(return_col)

    rows = []
    for model in models:
        x = panel.select(model_columns(model, variables_dict))
        for subset_name in subset_names:
            mask = torch.as_tensor(subset_masks[subset_name], device=y.device)
            cs, fm = fama_macbeth(y, x, mask, nw_lags=TABLE2_NW_LAGS)
            slope_valid = cs.month_valid[:, None] & torch.isfinite(cs.slopes)
            boot = block_bootstrap_se(cs.slopes, slope_valid, seed=seed,
                                      n_replicates=n_replicates,
                                      block_length=block_length, mesh=mesh)
            coef = fm.coef.cpu().numpy()
            nw_t = fm.tstat.cpu().numpy()
            se = boot.se.cpu().numpy()
            for i, label in enumerate(model.predictors):
                rows.append({
                    "Model": model.name,
                    "Predictor": label,
                    "Subset": subset_name,
                    "Slope": coef[i],
                    "Boot SE": se[i],
                    "t (boot)": coef[i] / se[i] if se[i] > 0 else np.nan,
                    "t (NW)": nw_t[i],
                })

    table = pd.DataFrame(rows).pivot(index=["Model", "Predictor"], columns="Subset",
                                     values=COLUMNS)
    table = table.swaplevel(0, 1, axis=1)
    table = table.reindex(labels=subset_names, axis=1, level=0)
    table = table.reindex(labels=COLUMNS, axis=1, level=1)
    return table.reindex([(m.name, label) for m in models for label in m.predictors])


def save_bootstrap_table(table: pd.DataFrame, output_dir) -> None:
    """Write ``bootstrap_se.pkl`` and ``bootstrap_se.tex`` (four decimals,
    blanks for NaN) under ``output_dir``."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    table.to_pickle(out / "bootstrap_se.pkl")
    (out / "bootstrap_se.tex").write_text(
        table.map(lambda v: f"{float(v):.4f}" if pd.notna(v) else "").to_latex()
    )
