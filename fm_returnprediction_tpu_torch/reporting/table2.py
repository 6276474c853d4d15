"""Table 2 — Fama-MacBeth slopes, t-stats and R² for 3 models × 3 universes.

Two routes (``specgrid.resolve_route``: the ``route`` argument, then
``FMRP_SPECGRID_ROUTE``, default "gram"):

- "gram": all nine (model, subset) cells are solved from one shared Gram
  contraction (``specgrid.run_spec_grid``), with the batched QR route as
  the per-cell referee;
- "stacked": every cell is a batched-QR ``fama_macbeth``. Below the
  ``reporting.fusion`` budget each model's subsets run as one batched call
  over the stacked subset masks (``_fm_sweep``); above it, one call per
  cell.

With a device ``mesh`` the route is ignored: every cell is one
``run_model_fm`` with the firm axis sharded (distributed TSQR,
``parallel.fm_sharded``), or on a 2-D months × firms mesh the hierarchy
(``parallel.multihost.fama_macbeth_hier``).

Layout and formatting follow the reference:

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

from fm_returnprediction_tpu_torch.guard import checks as _guard
from fm_returnprediction_tpu_torch.models.lewellen import MODELS, model_columns
from fm_returnprediction_tpu_torch.ops.fama_macbeth import (
    FamaMacbethSummary,
    fama_macbeth,
    fama_macbeth_summary,
)
from fm_returnprediction_tpu_torch.ops.ols import monthly_cs_ols
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.panel.subsets import SUBSET_ORDER
from fm_returnprediction_tpu_torch.reporting.fusion import fuse_over_subsets
from fm_returnprediction_tpu_torch.specgrid.estimators.core import resolve_estimator
from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid
from fm_returnprediction_tpu_torch.specgrid.specs import resolve_route, table2_grid

__all__ = ["table_2_cells", "format_table_2", "build_table_2", "run_model_fm"]

# Table 2's FM hyperparameters (NW lag 4, reference weight, 10 months; the
# stacked route's per-month solver is the QR one).
TABLE2_NW_LAGS = 4
TABLE2_MIN_MONTHS = 10
TABLE2_WEIGHT = "reference"
TABLE2_SOLVER = "qr"


def _host_summary(fm: FamaMacbethSummary) -> FamaMacbethSummary:
    return FamaMacbethSummary(*(leaf.cpu().numpy() for leaf in fm))


def _fm_sweep(y: torch.Tensor, x_all: torch.Tensor, masks: torch.Tensor, idxs):
    """Every (model, subset) FM summary: per model, one batched QR solve
    over the stacked subset masks (S, T, N). Returns one summary per model
    with a leading subset axis (numpy leaves)."""
    out = []
    for idx in idxs:
        cs = monthly_cs_ols(y, x_all[:, :, list(idx)], masks, record=False,
                            solver=TABLE2_SOLVER)
        out.append(_host_summary(fama_macbeth_summary(
            cs, nw_lags=TABLE2_NW_LAGS, min_months=TABLE2_MIN_MONTHS,
            weight=TABLE2_WEIGHT)))
    return out


def _stacked_summaries(y, x_all, subset_masks, idxs):
    """The stacked route: ``(model index, subset index) → summary`` (numpy
    leaves), fused or split by ``reporting.fusion.fuse_over_subsets``."""
    masks = torch.stack([torch.as_tensor(m, device=y.device) for m in subset_masks.values()])
    n_subsets = masks.shape[0]
    t, n = y.shape
    # priced as the reference prices its one fused program: Σ(p_i + 2) as
    # one design of that width (reporting.fusion)
    p_sum = sum(len(idx) + 2 for idx in idxs)
    if fuse_over_subsets(n_subsets, t, n, max(p_sum - 2, 0), x_all.element_size()):
        sweep = _fm_sweep(y, x_all, masks, idxs)
        for fm in sweep:
            # the batched calls fold the per-cell solves: account here
            _guard.record_fm_host("table2.fm_sweep", fm)
        return {(mi, si): FamaMacbethSummary(*(leaf[si] for leaf in fm))
                for mi, fm in enumerate(sweep) for si in range(n_subsets)}
    out = {}
    for mi, idx in enumerate(idxs):
        x = x_all[:, :, list(idx)]
        for si in range(n_subsets):
            _, fm = fama_macbeth(y, x, masks[si], nw_lags=TABLE2_NW_LAGS,
                                 min_months=TABLE2_MIN_MONTHS, weight=TABLE2_WEIGHT,
                                 solver=TABLE2_SOLVER)
            out[(mi, si)] = _host_summary(fm)
    return out


def run_model_fm(
    panel: DensePanel,
    subset_mask,
    model,
    variables_dict: Dict[str, str],
    return_col: str = "retx",
    nw_lags: int = TABLE2_NW_LAGS,
    solver: str = TABLE2_SOLVER,
    min_months: int = TABLE2_MIN_MONTHS,
    weight: str = TABLE2_WEIGHT,
    mesh=None,
    y: Optional[torch.Tensor] = None,
    x: Optional[torch.Tensor] = None,
):
    """One (model, subset) Fama-MacBeth on the dense panel: ``(cs, fm)``.

    With ``mesh`` the firm axis shards over its devices: ``solver`` "qr"
    runs distributed TSQR and "normal" the psum'd Gram (``n_refine`` 2 and
    0 of ``parallel.fm_sharded``); "lstsq" exists on one device only and
    raises with a mesh. A 2-D mesh runs the months × firms hierarchy.
    Without a mesh the one-device ``fama_macbeth`` runs with ``solver``.
    ``y``/``x`` take precomputed tensors (the model's columns)."""
    if y is None:
        y = panel.var(return_col)
    if x is None:
        x = panel.select(model_columns(model, variables_dict))
    mask = torch.as_tensor(subset_mask, device=y.device)
    if mesh is None:
        return fama_macbeth(y, x, mask, nw_lags=nw_lags, min_months=min_months,
                            weight=weight, solver=solver)
    if solver not in ("qr", "normal"):
        raise ValueError(f"solver={solver!r} is not available on a sharded mesh; use 'qr' "
                         "(distributed TSQR) or 'normal' (psum'd Gram)")
    n_refine = 0 if solver == "normal" else 2
    if len(mesh.axis_names) == 2:
        from fm_returnprediction_tpu_torch.parallel.multihost import fama_macbeth_hier

        month_axis, firm_axis = mesh.axis_names
        return fama_macbeth_hier(y, x, mask, mesh=mesh, month_axis=month_axis,
                                 firm_axis=firm_axis, nw_lags=nw_lags, min_months=min_months,
                                 weight=weight, n_refine=n_refine)
    from fm_returnprediction_tpu_torch.parallel.fm_sharded import fama_macbeth_sharded

    return fama_macbeth_sharded(y, x, mask, mesh=mesh, nw_lags=nw_lags, min_months=min_months,
                                weight=weight, axis_name=mesh.axis_names[0],
                                n_refine=n_refine)


def table_2_cells(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    variables_dict: Dict[str, str],
    models: Optional[list] = None,
    return_col: str = "retx",
    route: Optional[str] = None,
    mesh=None,
) -> Dict[Tuple[str, str], dict]:
    """Every Table 2 cell's numbers: ``(model name, subset) → {"coef",
    "tstat", "nw_se", "mean_r2", "mean_n"}`` (host numpy; coef/tstat/nw_se
    in the model's predictor order). ``route`` is "gram" or "stacked"
    (module docstring); "coreset" is refused, and so is an estimator other
    than OLS leaking in through ``FMRP_SPECGRID_ESTIMATOR``: Table 2 is the
    paper's OLS parity surface, where a partialled, absorbed or
    instrumented cell would be a silently different estimand. Both are
    resolved before a ``mesh`` (which ignores the route) takes over."""
    models = models if models is not None else MODELS
    subset_names = list(subset_masks)
    resolved = resolve_route(route, allowed=("gram", "stacked"))
    resolve_estimator(None, allowed=("ols",))
    grid = table2_grid(
        variables_dict, models=models, subsets=subset_names,
        nw_lags=TABLE2_NW_LAGS, min_months=TABLE2_MIN_MONTHS,
        weight=TABLE2_WEIGHT,
    )
    y = panel.var(return_col)
    x_all = panel.select(grid.union_predictors)
    if mesh is not None:
        col = {c: i for i, c in enumerate(grid.union_predictors)}
        summaries = {}
        for mi, model in enumerate(models):
            x = x_all[:, :, [col[c] for c in model_columns(model, variables_dict)]]
            for si, name in enumerate(subset_names):
                _, fm = run_model_fm(panel, subset_masks[name], model, variables_dict,
                                     return_col=return_col, mesh=mesh, y=y, x=x)
                summaries[(mi, si)] = _host_summary(fm)
    elif resolved == "gram":
        res = run_spec_grid(y, x_all, subset_masks, grid)
        summaries = {(mi, si): res.spec_summary(grid, mi * len(subset_names) + si)
                     for mi in range(len(models)) for si in range(len(subset_names))}
    else:
        col = {c: i for i, c in enumerate(grid.union_predictors)}
        idxs = [tuple(col[c] for c in model_columns(model, variables_dict))
                for model in models]
        summaries = _stacked_summaries(y, x_all, subset_masks, idxs)
    cells = {}
    for mi, model in enumerate(models):
        for si, name in enumerate(subset_names):
            fm = summaries[(mi, si)]
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
    mesh=None,
    return_col: str = "retx",
    route: Optional[str] = None,
) -> pd.DataFrame:
    """Assemble the formatted reference-layout Table 2 (``route`` and
    ``mesh`` as in :func:`table_2_cells`)."""
    cells = table_2_cells(panel, subset_masks, variables_dict, models=models,
                          return_col=return_col, route=route, mesh=mesh)
    return format_table_2(cells, list(subset_masks), models=models)
