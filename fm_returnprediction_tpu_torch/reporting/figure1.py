"""Figure 1 — 10-year rolling Fama-MacBeth slopes, two stacked panels.

Per subset ("All stocks" and "Large stocks"): monthly cross-sectional OLS
of retx on the FIGURE's own 5-variable set (complete-case over exactly
those columns), then a 120-month rolling mean (min 60) over the
CONSECUTIVE result months (row-based, as pandas ``rolling`` on the slope
frame).

``subset_sweep`` computes the figure/decile family for every subset on one
of two routes (``specgrid.resolve_route``: the ``route`` argument, then
``FMRP_SPECGRID_ROUTE``, default "gram"):

- "gram": one ``run_spec_grid`` over ``figure1_grid`` gives every subset's
  monthly cross-sections from one Gram contraction;
- "stacked": batched-QR ``monthly_cs_ols`` per subset, as one batched call
  over the stacked subset masks below the ``reporting.fusion`` budget and
  one call per subset above it.

On both, the rolled slope means of all subsets come from one rolling call,
and the decile legs reuse each subset's cross-section on the device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.guard import checks as _guard
from fm_returnprediction_tpu_torch.models.forecast import (
    DecileSortResult,
    decile_sorts,
    rolling_er_forecast,
)
from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS
from fm_returnprediction_tpu_torch.ops.compaction import rolling_over_valid_rows
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult, monthly_cs_ols
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.reporting.fusion import fuse_over_subsets
from fm_returnprediction_tpu_torch.specgrid.estimators.core import resolve_estimator
from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid
from fm_returnprediction_tpu_torch.specgrid.specs import figure1_grid, resolve_route

__all__ = ["SubsetSweepEntry", "figure_cs", "subset_sweep", "rolling_slopes",
           "figure_frames", "draw_figure_1", "create_figure_1"]


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


def _decile_legs(y, x, mask, cs, window, min_periods, n_deciles, min_obs):
    """Forecast + decile sorts for one subset from its cross-section
    (tensors on y's device) → numpy ``DecileSortResult``."""
    fr = rolling_er_forecast(y, x, mask, window=window, min_periods=min_periods, cs=cs)
    return DecileSortResult(*(_host(a) for a in decile_sorts(
        fr.er, fr.er_valid, y, n_deciles=n_deciles, min_obs=min_obs)))


def _rolling_batched(slopes: torch.Tensor, month_valid: torch.Tensor,
                     window: int, min_periods: int) -> np.ndarray:
    """Calendar-placed rolling slope means of every subset in one call:
    (S, T, P) in, (S, T, P) numpy out."""
    return _host(rolling_over_valid_rows(slopes, month_valid, window, min_periods))


def _subset_sweep_stacked(y, x, masks, names, window, min_periods, n_deciles,
                          min_obs, make_deciles):
    """The figure/decile family on the stacked route: the figure OLS of
    every subset in one batched call over the stacked masks (S, T, N), or
    one call per subset above the ``reporting.fusion`` budget; then the
    decile legs per subset and one rolling call. Returns (stacked numpy
    cross-sections, rolled means, per-subset deciles or Nones)."""
    stacked = torch.stack([masks[n] for n in names])
    t, n = y.shape
    if fuse_over_subsets(len(names), t, n, x.shape[-1], x.element_size()):
        cs = monthly_cs_ols(y, x, stacked, record=False)
    else:
        per = [monthly_cs_ols(y, x, stacked[i], record=False) for i in range(len(names))]
        cs = CSRegressionResult(*(torch.stack(leaves) for leaves in zip(*per)))
    decs = [_decile_legs(y, x, stacked[i], CSRegressionResult(*(a[i] for a in cs)),
                         window, min_periods, n_deciles, min_obs)
            if make_deciles else None for i in range(len(names))]
    rolled = _rolling_batched(cs.slopes, cs.month_valid, window, min_periods)
    cs_all = CSRegressionResult(*(_host(a) for a in cs))
    # the batched solves fold the per-subset records: account here
    _guard.record_cs_host("figure.subset_sweep", cs_all)
    return cs_all, rolled, decs


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
    route: Optional[str] = None,
) -> Dict[str, SubsetSweepEntry]:
    """The figure/decile family for the subsets in ``names`` on the Gram
    or the stacked route (module docstring; "coreset" is refused); numpy
    results per subset. The sweep is a paper-parity surface: a non-OLS
    estimator leaking in through ``FMRP_SPECGRID_ESTIMATOR`` raises before
    any compute, as Table 2's does."""
    names = [n for n in names if n in subset_masks]
    if not names:
        return {}
    resolve_estimator(None, allowed=("ols",))
    resolved = resolve_route(route, allowed=("gram", "stacked"))
    y = panel.var(return_col)
    x = panel.select(list(FIGURE1_VARS.keys()))
    device = y.device
    masks = {n: torch.as_tensor(subset_masks[n], device=device) for n in names}
    params = (window, min_periods, n_deciles, min_obs)
    if resolved == "stacked":
        cs_all, rolled, decs = _subset_sweep_stacked(
            y, x, masks, names, window, min_periods, n_deciles, min_obs, make_deciles)
        return {name: SubsetSweepEntry(CSRegressionResult(*(a[i] for a in cs_all)),
                                       rolled[i], decs[i],
                                       params if decs[i] is not None else None)
                for i, name in enumerate(names)}
    grid = figure1_grid(names)
    res = run_spec_grid(y, x, masks, grid)
    # every subset's (T, 5) slope series rolls in one call
    rolled = _rolling_batched(torch.as_tensor(res.slopes, device=device),
                              torch.as_tensor(res.month_valid, device=device),
                              window, min_periods)
    out = {}
    for i, name in enumerate(names):
        cs_np = res.spec_cs(grid, i)
        dec = None
        if make_deciles:
            cs_dev = CSRegressionResult(*(torch.as_tensor(a, device=device)
                                          for a in cs_np))
            dec = _decile_legs(y, x, masks[name], cs_dev, window, min_periods,
                               n_deciles, min_obs)
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


def draw_figure_1(frames: Dict[str, pd.DataFrame]) -> Tuple[object, object]:
    """Draw Figure 1 from its rolling-slope frames (``figure_frames``, or
    ``PipelineResult.figure_1``): two stacked panels, All / Large stocks.
    Needs matplotlib, imported here; ``fig.savefig`` writes a file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(nrows=2, ncols=1, figsize=(14, 10), sharex=True)
    panel_specs = [
        ("All stocks", axes[0], "Panel A: All Stocks (10-Year Rolling Slopes)"),
        ("Large stocks", axes[1], "Panel B: Large Stocks (10-Year Rolling Slopes)"),
    ]
    for subset_name, ax, title in panel_specs:
        if subset_name not in frames:
            continue
        frame = frames[subset_name]
        for var, label in FIGURE1_VARS.items():
            ax.plot(frame.index, frame[var], label=label)
        ax.set_title(title)
        ax.set_ylabel("Slope Coefficient")
        ax.legend()
        ax.margins(x=0)
    axes[1].set_xlabel("Month")
    fig.tight_layout()
    return fig, axes


def create_figure_1(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    save_plot: bool = False,
    output_dir=None,
    cs_cache: Optional[Dict[str, SubsetSweepEntry]] = None,
) -> Tuple[object, object]:
    """Two stacked panels (All / Large stocks) of 10-year rolling slopes
    (``figure_frames`` drawn by ``draw_figure_1``; needs matplotlib). With
    ``save_plot`` and an ``output_dir`` the figure is also written there as
    ``figure_1.pdf``."""
    fig, axes = draw_figure_1(figure_frames(panel, subset_masks, cs_cache))
    if save_plot and output_dir is not None:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        fig.savefig(Path(output_dir) / "figure_1.pdf", bbox_inches="tight")
    return fig, axes
