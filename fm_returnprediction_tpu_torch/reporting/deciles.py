"""Decile-sort table: out-of-sample forecast portfolios per size universe.

For each subset, the figure's 5-variable rolling FM forecasts feed
``models.forecast`` and the table reports each decile's mean realized
monthly return plus the 10−1 spread and its NW t-statistic.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.models.forecast import decile_sorts, rolling_er_forecast
from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.panel.subsets import SUBSET_ORDER
from fm_returnprediction_tpu_torch.reporting.figure1 import SubsetSweepEntry

__all__ = ["build_decile_table", "save_decile_table"]


def build_decile_table(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    return_col: str = "retx",
    window: int = 120,
    min_periods: int = 60,
    n_deciles: int = 10,
    min_obs: int = 50,
    cs_cache: Optional[Dict[str, SubsetSweepEntry]] = None,
) -> pd.DataFrame:
    """Rows: Decile 1 (low Ê[r]) … Decile 10 (high), ``10-1 spread``,
    ``t(spread)``, ``Months``; index name ``"Portfolio"``. Columns: the
    three size universes. With ``cs_cache`` (``figure1.subset_sweep`` entries
    for every universe) each column is its entry's finished decile result,
    and parameters other than those the sweep ran with raise; without it
    each universe's forecast and sorts are computed here."""
    params = (window, min_periods, n_deciles, min_obs)
    cols = {}
    for subset in SUBSET_ORDER:
        if cs_cache is not None:
            entry = cs_cache[subset]
            if entry.decile_params != params:
                raise ValueError(f"{subset}: the sweep's decile parameters "
                                 f"{entry.decile_params} are not {params}")
            res = entry.deciles
        else:
            y = panel.var(return_col)
            x = panel.select(list(FIGURE1_VARS.keys()))
            mask = torch.as_tensor(subset_masks[subset], device=y.device)
            fr = rolling_er_forecast(y, x, mask, window=window,
                                     min_periods=min_periods)
            res = decile_sorts(fr.er, fr.er_valid, y, n_deciles=n_deciles,
                               min_obs=min_obs)
        mean_returns = np.asarray(torch.as_tensor(res.mean_returns).cpu())
        col = {f"Decile {d + 1}": float(mean_returns[d]) for d in range(n_deciles)}
        col["10-1 spread"] = float(res.spread)
        col["t(spread)"] = float(res.spread_tstat)
        col["Months"] = int(res.n_months)
        cols[subset] = col

    table = pd.DataFrame(cols)
    table.index.name = "Portfolio"
    return table


def save_decile_table(table: pd.DataFrame, output_dir) -> None:
    """Persist the decile table (pickle + LaTeX). The Months row renders as
    integers; everything else gets 4 decimals."""
    from pathlib import Path

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    table.to_pickle(out / "decile_sorts.pkl")
    tex = table.copy().astype(object)
    tex.loc["Months"] = [f"{int(v):d}" for v in table.loc["Months"]]
    for row in tex.index:
        if row != "Months":
            tex.loc[row] = [f"{float(v):.4f}" for v in table.loc[row]]
    (out / "decile_sorts.tex").write_text(tex.to_latex())
