"""Figure 1 — 10-year rolling Fama-MacBeth slopes, two stacked panels.

Per subset ("All stocks" and "Large stocks"): monthly cross-sectional OLS
of retx on the FIGURE's own 5-variable set (complete-case over exactly
those columns), then a 120-month rolling mean (min 60) over the
CONSECUTIVE result months (row-based, as pandas ``rolling`` on the slope
frame).

``subset_sweep`` computes the figure/decile family for every subset on the
Gram route: one ``run_spec_grid`` over ``figure1_grid`` gives every
subset's monthly cross-sections from one Gram contraction, the rolled
slope means of all subsets come from one rolling call, and the decile legs
reuse each subset's cross-section on the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.models.forecast import (
    DecileSortResult,
    decile_sorts,
    rolling_er_forecast,
)
from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS
from fm_returnprediction_tpu_torch.ops.compaction import rolling_over_valid_rows
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult, monthly_cs_ols
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid
from fm_returnprediction_tpu_torch.specgrid.specs import figure1_grid

__all__ = ["SubsetSweepEntry", "figure_cs", "subset_sweep", "rolling_slopes",
           "figure_frames", "create_figure_1"]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def figure_cs(panel: DensePanel, subset_mask, return_col: str = "retx"):
    """Batched monthly OLS on the figure's 5-variable set for one subset
    (tensors on the panel's device)."""
    y = panel.var(return_col)
    x = panel.select(list(FIGURE1_VARS.keys()))
    return monthly_cs_ols(y, x, torch.as_tensor(subset_mask, device=y.device))


class SubsetSweepEntry(NamedTuple):
    """One subset's figure/decile results, on the host (numpy leaves)."""

    cs: CSRegressionResult       # per-month cross-sections
    rolled: np.ndarray           # (T, 5) rolling slope means, calendar-placed
    deciles: Optional[DecileSortResult]
    decile_params: Optional[Tuple[int, int, int, int]] = None
    # (window, min_periods, n_deciles, min_obs) of `deciles`;
    # build_decile_table raises when they differ from its own


def subset_sweep(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    names,
    return_col: str = "retx",
    window: int = 120,
    min_periods: int = 60,
    n_deciles: int = 10,
    min_obs: int = 50,
    make_deciles: bool = True,
) -> Dict[str, SubsetSweepEntry]:
    """The figure/decile family for the subsets in ``names`` on the Gram
    route; numpy results per subset."""
    names = [n for n in names if n in subset_masks]
    if not names:
        return {}
    y = panel.var(return_col)
    x = panel.select(list(FIGURE1_VARS.keys()))
    device = y.device
    masks = {n: torch.as_tensor(subset_masks[n], device=device) for n in names}
    grid = figure1_grid(names)
    res = run_spec_grid(y, x, masks, grid)
    # every subset's (T, 5) slope series rolls in one call
    rolled = _host(rolling_over_valid_rows(
        torch.as_tensor(res.slopes, device=device),
        torch.as_tensor(res.month_valid, device=device), window, min_periods,
    ))
    params = (window, min_periods, n_deciles, min_obs)
    out = {}
    for i, name in enumerate(names):
        cs_np = res.spec_cs(grid, i)
        dec = None
        if make_deciles:
            cs_dev = CSRegressionResult(*(torch.as_tensor(a, device=device)
                                          for a in cs_np))
            fr = rolling_er_forecast(y, x, masks[name], window=window,
                                     min_periods=min_periods, cs=cs_dev)
            dec = DecileSortResult(*(_host(a) for a in decile_sorts(
                fr.er, fr.er_valid, y, n_deciles=n_deciles, min_obs=min_obs)))
        out[name] = SubsetSweepEntry(cs_np, rolled[i], dec,
                                     params if dec is not None else None)
    return out


def rolling_slopes(
    panel: DensePanel,
    subset_mask,
    window: int = 120,
    min_periods: int = 60,
    return_col: str = "retx",
    cs=None,
    rolled=None,
) -> pd.DataFrame:
    """120-month rolling mean of monthly figure slopes for one subset: a
    frame indexed by month (``mthcaldt``) with one column per figure
    variable, over the months whose cross-section ran. ``cs`` reuses a
    precomputed ``figure_cs`` result, ``rolled`` its calendar-placed
    rolling means (both as ``subset_sweep`` entries carry them)."""
    xvars = list(FIGURE1_VARS.keys())
    if cs is None:
        cs = figure_cs(panel, subset_mask, return_col)
    if rolled is None:
        rolled = rolling_over_valid_rows(torch.as_tensor(cs.slopes),
                                         torch.as_tensor(cs.month_valid),
                                         window, min_periods)
    valid = _host(cs.month_valid)
    months = pd.DatetimeIndex(panel.months)[valid]
    frame = pd.DataFrame(_host(rolled)[valid], index=months, columns=xvars)
    frame.index.name = "mthcaldt"
    return frame


def figure_frames(panel: DensePanel, subset_masks: Dict[str, torch.Tensor],
                  cs_cache: Optional[Dict[str, SubsetSweepEntry]] = None
                  ) -> Dict[str, pd.DataFrame]:
    """The rolling-slope frames Figure 1 plots: subset → ``rolling_slopes``
    frame for "All stocks" and "Large stocks" (where present), from the
    ``subset_sweep`` entries when given, else computed here."""
    frames = {}
    for subset_name in ("All stocks", "Large stocks"):
        if subset_name in subset_masks:
            cs = rolled = None
            if cs_cache is not None:
                cs, rolled = cs_cache[subset_name].cs, cs_cache[subset_name].rolled
            frames[subset_name] = rolling_slopes(
                panel, subset_masks[subset_name], cs=cs, rolled=rolled)
    return frames


def create_figure_1(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    cs_cache: Optional[Dict[str, SubsetSweepEntry]] = None,
) -> Tuple[object, object]:
    """Two stacked panels (All / Large stocks) of 10-year rolling slopes.
    Needs matplotlib, imported here; ``run_pipeline`` computes the frames
    (``figure_frames``) and does not draw. ``fig.savefig`` writes a file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    slopes_dict = figure_frames(panel, subset_masks, cs_cache)
    fig, axes = plt.subplots(nrows=2, ncols=1, figsize=(14, 10), sharex=True)
    panel_specs = [
        ("All stocks", axes[0], "Panel A: All Stocks (10-Year Rolling Slopes)"),
        ("Large stocks", axes[1], "Panel B: Large Stocks (10-Year Rolling Slopes)"),
    ]
    for subset_name, ax, title in panel_specs:
        if subset_name not in slopes_dict:
            continue
        frame = slopes_dict[subset_name]
        for var, label in FIGURE1_VARS.items():
            ax.plot(frame.index, frame[var], label=label)
        ax.set_title(title)
        ax.set_ylabel("Slope Coefficient")
        ax.legend()
        ax.margins(x=0)
    axes[1].set_xlabel("Month")
    fig.tight_layout()
    return fig, axes
