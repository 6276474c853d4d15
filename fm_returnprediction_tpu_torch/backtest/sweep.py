"""The backtest tile runner — cells streamed to sinks, with the
zero-panel-contraction proof.

``run_backtest`` walks a ``BacktestSpace`` tile by tile and emits ONE ROW
PER CELL. The execution grouping follows the space's dimension order:

- a ONE-SLOT path memo keyed by the (scheme, estimator) digits — cells are
  contiguous in that key, so one coefficient-path solve
  (``backtest_paths``) is live at a time;
- a ONE-SLOT pair memo keyed by (path, pair) for the predicted-E[r] panel
  (kept on the device) and the weighting-independent metrics (OOS R², IC
  series and their inference), which the EW and VW cells of a pair share;
- the portfolio sort (``quantile_sorts``) per cell.

Everything after the bank is per-month Gram re-aggregation plus O(N·P)
forecast products, so the panel-contraction counters
(``specgrid.solve.contraction_counts``) must not move during the sweep:
``run_backtest`` returns the delta as ``panel_contractions`` (0), and on
the card no Gram kernel launches after the bank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.backtest.evaluate import (
    bootstrap_series,
    ic_series,
    oos_r2,
    series_inference,
)
from fm_returnprediction_tpu_torch.backtest.paths import (
    _host,
    _predict_pair,
    backtest_paths,
    resolve_backtest_route,
)
from fm_returnprediction_tpu_torch.backtest.portfolio import quantile_sorts
from fm_returnprediction_tpu_torch.backtest.sinks import (
    resolve_backtest_sink,
    resolve_backtest_sink_name,
)
from fm_returnprediction_tpu_torch.backtest.space import BacktestSpace, backtest_space
from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.specgrid.solve import contraction_counts

__all__ = ["run_backtest", "run_backtest_scenarios"]


def _finite_mean(series: np.ndarray) -> float:
    good = np.isfinite(series)
    return float(series[good].mean()) if good.any() else float("nan")


def run_backtest_scenarios(
    panel,
    subset_masks: Dict[str, object],
    variables_dict: Dict[str, str],
    models=None,
    universes=None,
    schemes=None,
    estimator=None,
    weightings=("ew", "vw"),
    n_quantiles: Optional[int] = None,
    min_obs: int = 50,
    route: Optional[str] = None,
    sink=None,
    output_dir=None,
    weights_col: str = "me",
    return_col: str = "retx",
    nw_lags: int = 4,
    min_months: int = 10,
    bootstrap: int = 1,
    seed: int = 0,
    return_stats: bool = False,
    device=None,
):
    """The pipeline's backtest stage on ``device`` (``None`` → the GPU):
    contract the scenario panel ONCE into a Gram bank
    (``specgrid.scenarios.bank_for_scenarios``, one K2 launch on the card),
    then answer the whole cell product (scheme × estimator × model ×
    universe × weighting) from it with :func:`run_backtest`.

    ``estimator`` is one grammar string or ``Estimator`` (``"fwl:beme"``)
    swept in place of OLS when given; ``weights_col`` is the VW weight
    variable (market equity) — a panel without it drops the VW cells, and
    the stats disclose the reduction (``weighting_reduced``). Returns the
    sink's frame, or ``(frame, stats)`` under ``return_stats=True``."""
    from fm_returnprediction_tpu_torch.specgrid.estimators.core import EST_OLS
    from fm_returnprediction_tpu_torch.specgrid.scenarios import bank_for_scenarios

    dev = resolve_device(device)
    universes = list(universes) if universes is not None else list(subset_masks)
    bank = bank_for_scenarios(panel, subset_masks, variables_dict, models=models,
                              universes=universes, nw_lags=nw_lags, min_months=min_months,
                              return_col=return_col, fingerprint="backtest", device=dev)
    estimators = (EST_OLS,) if estimator is None else (estimator,)
    weightings = tuple(weightings)
    weights = None
    reduced = False
    if "vw" in weightings:
        if weights_col in panel.var_names:
            weights = panel.var(weights_col)
        else:
            weightings = tuple(w for w in weightings if w != "vw")
            reduced = True
            if not weightings:
                raise ValueError(f"panel lacks the weight column {weights_col!r} and only "
                                 "'vw' was requested")
    space = backtest_space(bank, schemes=schemes, estimators=estimators,
                           weightings=weightings, n_quantiles=n_quantiles, min_obs=min_obs)
    frame, stats = run_backtest(
        bank, panel.select(list(bank.union)), panel.var(return_col),
        {name: subset_masks[name] for name in space.universes}, space=space,
        weights_var=weights, sink=sink, output_dir=output_dir, route=route,
        min_months=min_months, bootstrap=bootstrap, seed=seed, device=dev)
    stats["weighting_reduced"] = reduced
    if return_stats:
        return frame, stats
    return frame


def run_backtest(
    bank,
    x,
    realized,
    universe_masks: Dict[str, object],
    space: Optional[BacktestSpace] = None,
    weights_var=None,
    sink=None,
    output_dir=None,
    tile_cells: Optional[int] = None,
    route: Optional[str] = None,
    min_months: Optional[int] = None,
    bootstrap: int = 1,
    seed: int = 0,
    block: Optional[int] = None,
    device=None,
) -> Tuple[pd.DataFrame, Dict[str, object]]:
    """Run one backtest sweep over a bank on ``device`` (``None`` → the
    GPU), streaming cell rows to a sink.

    ``x`` is the (T, N, P) lagged-characteristic panel in the BANK's union
    column order; ``realized`` the (T, N) returns the forecasts are scored
    against; ``universe_masks`` maps each of the space's universes to its
    (T, N) mask; ``weights_var`` the (T, N) value-weight variable, required
    iff the space includes ``"vw"`` (numpy arrays or tensors). ``bootstrap``
    counts draws including the point estimate; above 1 each cell's spread
    series is block-bootstrapped over origins (``spread_boot_se``).

    Returns ``(sink.finish(), stats)``: ``stats`` carries
    ``panel_contractions`` (0: the sweep never contracts the panel), the
    resolved route and sink, and the solve/prediction counts."""
    if space is None:
        space = backtest_space(bank)
    expect = tuple((s, u) for s in space.sets for u in space.universes)
    if expect != tuple(bank.pair_labels):
        raise ValueError(f"space pair product {expect} does not address the bank's pair "
                         f"axis {tuple(bank.pair_labels)}")
    missing = [u for u in space.universes if u not in universe_masks]
    if missing:
        raise KeyError(f"universe masks missing for {missing}")
    if "vw" in space.weightings and weights_var is None:
        raise ValueError("space includes 'vw' weighting but no weights_var was given — a "
                         "value-weighted portfolio needs the weight panel")
    route = resolve_backtest_route(route)
    sink_obj = resolve_backtest_sink(sink, output_dir=output_dir)
    sink_name = resolve_backtest_sink_name(sink_obj)
    if int(bootstrap) < 1:
        raise ValueError("bootstrap counts the point estimate; must be >= 1")

    dev = resolve_device(device)
    x_dev = torch.as_tensor(x, device=dev)
    realized_dev = torch.as_tensor(realized, device=dev).to(x_dev.dtype)
    weights_dev = None if weights_var is None else torch.as_tensor(weights_var, device=dev)

    before = contraction_counts()
    path_memo: Dict[tuple, object] = {}
    pair_memo: Dict[tuple, dict] = {}
    path_solves = predict_calls = n_tiles = 0

    for tile in space.tiles(tile_cells):
        n_tiles += 1
        rows = []
        for cell in tile.cells():
            pkey = space.path_key(cell.index)
            if pkey not in path_memo:
                path_memo.clear()  # one slot: cells are contiguous in pkey
                path_memo[pkey] = backtest_paths(bank, scheme=cell.scheme,
                                                 estimator=cell.estimator,
                                                 min_months=min_months, route=route,
                                                 device=dev)
                path_solves += 1
            paths = path_memo[pkey]

            mkey = (pkey, cell.pair)
            if mkey not in pair_memo:
                pair_memo.clear()  # one slot: weighting is innermost
                er, er_valid = _predict_pair(paths, x_dev, universe_masks[cell.universe],
                                             cell.pair)
                predict_calls += 1
                ic, rank_ic, _ = ic_series(er, er_valid, realized_dev)
                ic_mean, ic_se, ic_t, ic_n = series_inference(_host(ic), nw_lags=space.nw_lags,
                                                              device=dev)
                rk_mean, _, rk_t, _ = series_inference(_host(rank_ic), nw_lags=space.nw_lags,
                                                       device=dev)
                pair_memo[mkey] = {
                    "er": er, "er_valid": er_valid,
                    "oos_r2": float(oos_r2(er, er_valid, realized_dev)),
                    "ic_mean": ic_mean, "ic_nw_se": ic_se, "ic_tstat": ic_t,
                    "ic_months": ic_n, "rank_ic_mean": rk_mean, "rank_ic_tstat": rk_t,
                    "forecast_months": int(er_valid.any(dim=1).sum()),
                    "suspect_months": int(paths.suspect[cell.pair].sum()),
                }
            m = pair_memo[mkey]

            vw = cell.weighting == "vw"
            port = quantile_sorts(m["er"], m["er_valid"], realized_dev,
                                  weights=weights_dev if vw else None,
                                  n_quantiles=space.n_quantiles, min_obs=space.min_obs,
                                  nw_lags=space.nw_lags, value_weighted=vw)
            mean_returns = _host(port.mean_returns)
            row = {
                "cell": cell.index,
                "scheme": cell.scheme,
                "estimator": cell.estimator.label,
                "set": cell.set_name,
                "universe": cell.universe,
                "weighting": cell.weighting,
                "route": paths.route,
                "quantiles": space.n_quantiles,
                "oos_r2": m["oos_r2"],
                "ic_mean": m["ic_mean"],
                "ic_nw_se": m["ic_nw_se"],
                "ic_tstat": m["ic_tstat"],
                "ic_months": m["ic_months"],
                "rank_ic_mean": m["rank_ic_mean"],
                "rank_ic_tstat": m["rank_ic_tstat"],
                "bottom_ret": float(mean_returns[0]),
                "top_ret": float(mean_returns[-1]),
                "spread": float(port.spread),
                "spread_nw_se": float(port.spread_nw_se),
                "spread_tstat": float(port.spread_tstat),
                "spread_turnover": _finite_mean(_host(port.spread_turnover)),
                "n_months": int(port.n_months),
                "forecast_months": m["forecast_months"],
                "suspect_months": m["suspect_months"],
            }
            if int(bootstrap) > 1:
                spread_series = _host(port.spread_series)
                point, boot_se, _ = bootstrap_series(
                    spread_series, valid=np.isfinite(spread_series), draws=int(bootstrap),
                    seed=seed, block=block, nw_lags=space.nw_lags, device=dev)
                row["spread_boot_se"] = float(boot_se[0])
                row["spread_boot_point"] = float(point[0])
            rows.append(row)
        sink_obj.consume(pd.DataFrame(rows))

    after = contraction_counts()
    stats = {
        "cells": len(space),
        "tiles": n_tiles,
        "route": route,
        "sink": sink_name,
        "schemes": list(space.schemes),
        "weightings": list(space.weightings),
        "quantiles": space.n_quantiles,
        "bootstrap": int(bootstrap),
        "path_solves": path_solves,
        "predict_calls": predict_calls,
        "rows_seen": sink_obj.rows_seen,
        # the sweep re-aggregates Grams and runs O(N·P) forecast products:
        # the panel-contraction counters must not move
        "panel_contractions": sum(after.get(k, 0) - before.get(k, 0)
                                  for k in ("specs_contracted", "pairs_contracted")),
    }
    return sink_obj.finish(), stats
