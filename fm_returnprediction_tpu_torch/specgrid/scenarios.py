"""Robustness scenario grids — subperiods × universes × winsor × weights.

The scenario sweep on the Gram engine: the cell product (models ×
universes × subperiod windows × winsor levels × NW weight schemes ×
bootstrap draws) is enumerated lazily through ``cellspace.CellSpace`` and
solved tile by tile by ``engine.run_cellspace``, whose rows stream through
a configurable sink.

Winsor variants: the panel's characteristics are stored winsorized at
[1%, 99%]. The base clip moves only order statistics in the outer 1% tails,
so re-winsorizing the stored columns at a TIGHTER level (e.g. 5/95) equals
winsorizing the raw data there whenever the tighter quantile's
interpolation ranks clear the ranks the base clip altered — for 1%→5% that
is every month with ≥ 21 valid names. Thinner months are a clip-of-clip
approximation; levels looser than the base are not recoverable and are
rejected. The re-clip runs through the batched (V, T, N) winsorizer
(``ops.quantiles.winsorize_cs_batched``).

``bank_for_scenarios`` contracts the sweep's panel ONCE into an in-memory
Gram bank (``specgrid.grambank``) and ``run_scenarios_banked`` answers
window and bootstrap scenarios from it without reading the panel again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.ops.quantiles import winsorize_cs_batched
from fm_returnprediction_tpu_torch.specgrid.specs import SpecGrid, product_grid

__all__ = [
    "subperiod_windows",
    "winsor_variant",
    "scenario_grid",
    "run_scenarios",
    "bank_for_scenarios",
    "run_scenarios_banked",
]


def subperiod_windows(n_months: int, pieces: int = 2) -> Dict[str, Optional[Tuple[int, int]]]:
    """Equal half-open month-index windows, e.g. ``{"sub1of2": (0, 300),
    "sub2of2": (300, 600)}`` — after the full sample under ``"full"``."""
    if pieces < 1:
        raise ValueError("pieces must be >= 1")
    out: Dict[str, Optional[Tuple[int, int]]] = {"full": None}
    edges = np.linspace(0, n_months, pieces + 1).astype(int)
    if pieces > 1:
        for i in range(pieces):
            out[f"sub{i + 1}of{pieces}"] = (int(edges[i]), int(edges[i + 1]))
    return out


def winsor_variant(x: torch.Tensor, mask: torch.Tensor, level: float,
                   base_level: float = 1.0, scratch: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Re-clip the (T, N, P) union tensor, already winsorized at
    ``base_level``, at ``[level, 100-level]`` percent (module docstring for
    when that equals the raw-data variant); looser levels are rejected.
    ``scratch``, a dead tensor of the output's shape, dtype and device (the
    previous level's variant), is written over and returned in place of a
    new allocation; one that does not fit is ignored."""
    if level < base_level:
        raise ValueError(
            f"winsor level {level}% is looser than the panel's base {base_level}% — "
            "the clipped tails cannot be undone")
    if level == base_level:
        return x
    win = winsorize_cs_batched(x.movedim(-1, 0), mask, float(level), float(100.0 - level))
    if (isinstance(scratch, torch.Tensor) and scratch.shape == x.shape
            and scratch.dtype == x.dtype and scratch.device == x.device
            and scratch.is_contiguous()):
        return scratch.copy_(win.movedim(0, -1))
    return win.movedim(0, -1).contiguous()


def scenario_grid(
    variables_dict: Dict[str, str],
    universes: Sequence[str],
    n_months: int,
    models=None,
    subperiods: int = 2,
    tag: str = "",
    nw_lags: int = 4,
    min_months: int = 10,
    weight: str = "reference",
) -> SpecGrid:
    """Model × universe × subperiod grid in one ``SpecGrid`` (the
    ``product_grid`` order the sweep's cell space also follows)."""
    from fm_returnprediction_tpu_torch.models.lewellen import MODELS, model_columns

    models = models if models is not None else MODELS
    regressor_sets = {m.name: tuple(model_columns(m, variables_dict)) for m in models}
    return product_grid(regressor_sets, universes, subperiod_windows(n_months, subperiods),
                        tag=tag, nw_lags=nw_lags, min_months=min_months, weight=weight)


def run_scenarios(
    panel,
    subset_masks: Dict[str, object],
    variables_dict: Dict[str, str],
    models=None,
    universes: Optional[Sequence[str]] = None,
    subperiods: int = 2,
    winsor_levels: Sequence[float] = (1.0,),
    weights: Sequence[str] = ("reference",),
    nw_lags: int = 4,
    min_months: int = 10,
    return_col: str = "retx",
    referee: bool = True,
    bootstrap: int = 1,
    cells: Optional[int] = None,
    tile_cells: Optional[int] = None,
    sink=None,
    route: str = "gram",
    mesh=None,
    seed: int = 0,
    coreset_m: Optional[int] = None,
    coreset_budget_mb: Optional[float] = None,
    output_dir=None,
    return_stats: bool = False,
    precision: Optional[str] = None,
    factorize: Optional[str] = None,
    estimators=None,
    fe_codes: Optional[Dict[str, object]] = None,
):
    """The scenario sweep: one tidy row per (cell, predictor).

    ``panel`` is the enriched ``DensePanel`` (values on the compute
    device), ``subset_masks`` its universes. Returns the sink's result
    frame, or ``(frame, stats)`` with ``return_stats=True``.

    Columns: the cell's global address (``cell``), the scenario dimensions
    (model/universe/window/winsor_pct/nw_weight, plus ``draw`` when
    bootstrap draws are requested), the FM estimates (coef/tstat/nw_se),
    the cell diagnostics (mean_r2/mean_n/n_months) and ``refereed`` (the
    batched-QR referee re-solved the cell); coreset cells add their
    sampling disclosure (route/coreset_m/coreset_rate/suspect_months), bf16
    cells ``precision`` and ``bf16_promoted_months``.

    ``cells=N`` grows the bootstrap-draw dimension until the space holds at
    least N cells. ``sink`` is a ``sinks.Sink``, a sink name, or None (the
    ``FMRP_SPECGRID_SINK`` / full-frame default). ``estimators`` adds the
    estimator dimension: ``Estimator`` values or grammar strings
    (``"fwl:log_size@iid"``, ``parse_estimator``); None keeps the OLS@NW
    space and its row schema. ``fe_codes`` maps FE names → (T, N) int code
    arrays for ``absorb`` cells. ``mesh`` (default ``FMRP_SPECGRID_MESH``)
    runs the OLS batches on a device mesh (``specgrid.sharded``).
    """
    from fm_returnprediction_tpu_torch.models.lewellen import MODELS
    from fm_returnprediction_tpu_torch.specgrid.cellspace import scenario_space
    from fm_returnprediction_tpu_torch.specgrid.engine import run_cellspace

    models = models if models is not None else MODELS
    universes = list(universes) if universes is not None else list(subset_masks)
    label_of = {col: label for label, col in variables_dict.items()}

    t = len(panel.months)
    est_kwargs = {}
    if estimators is not None:
        from fm_returnprediction_tpu_torch.specgrid.estimators import (
            Estimator,
            parse_estimator,
        )

        est_kwargs["estimators"] = tuple(
            e if isinstance(e, Estimator) else parse_estimator(str(e)) for e in estimators)
    space = scenario_space(
        variables_dict, universes, t, models=models, subperiods=subperiods,
        winsor_levels=winsor_levels, weights=weights, bootstrap=bootstrap,
        nw_lags=nw_lags, min_months=min_months, **est_kwargs,
    )
    if cells is not None and cells > len(space):
        # grow the draw dimension (the only one that scales freely) until
        # the space covers the requested cell count
        base = len(space) // space.bootstrap
        space = dataclasses.replace(
            space, bootstrap=max(space.bootstrap, math.ceil(cells / base)))

    y = torch.as_tensor(panel.var(return_col))
    x_base = torch.as_tensor(panel.select(list(space.union_predictors))).contiguous()
    frame, stats = run_cellspace(
        y, x_base, {n: subset_masks[n] for n in universes}, space,
        sink=sink, tile_cells=tile_cells, route=route, mesh=mesh,
        referee=referee, mask=panel.mask, label_of=label_of, seed=seed,
        coreset_m=coreset_m, coreset_budget_mb=coreset_budget_mb,
        output_dir=output_dir, precision=precision, factorize=factorize,
        fe_codes=fe_codes,
    )
    if return_stats:
        return frame, stats
    return frame


def bank_for_scenarios(
    panel,
    subset_masks: Dict[str, object],
    variables_dict: Dict[str, str],
    models=None,
    universes: Optional[Sequence[str]] = None,
    subperiods: int = 2,
    nw_lags: int = 4,
    min_months: int = 10,
    return_col: str = "retx",
    fingerprint: str = "scenarios",
    precision: Optional[str] = None,
    device=None,
):
    """Contract the scenario sweep's panel ONCE into a month-addressed
    :class:`~fm_returnprediction_tpu_torch.specgrid.grambank.GramBank` on
    ``device`` (``None`` → the GPU): one unwindowed per-month Gram per
    (model, universe) pair, from which ``run_scenarios_banked`` answers
    window and bootstrap scenarios in O(T·Q²) without re-reading the (T, N,
    P) panel. Month labels are INDEX positions (0..T-1), matching
    ``subperiod_windows``'s half-open ranges."""
    from fm_returnprediction_tpu_torch.models.lewellen import MODELS
    from fm_returnprediction_tpu_torch.specgrid.cellspace import scenario_space
    from fm_returnprediction_tpu_torch.specgrid.grambank import build_bank

    models = models if models is not None else MODELS
    universes = list(universes) if universes is not None else list(subset_masks)
    t = len(panel.months)
    space = scenario_space(variables_dict, universes, t, models=models,
                           subperiods=subperiods, nw_lags=nw_lags, min_months=min_months)
    return build_bank(
        panel.var(return_col), panel.select(list(space.union_predictors)),
        {n: subset_masks[n] for n in universes}, space, fingerprint=fingerprint,
        precision=precision, device=device)


def run_scenarios_banked(
    bank,
    windows: Optional[Dict[str, object]] = None,
    bootstrap: int = 1,
    seed: int = 0,
    weights: Sequence[str] = ("reference",),
    variables_dict: Optional[Dict[str, str]] = None,
    estimator=None,
    device=None,
):
    """The scenarios path over BANKED stats: a tidy frame in the
    ``run_scenarios`` row schema, answered from the bank's month-axis Grams
    on ``device`` — a new subperiod split or bootstrap depth costs O(T·Q²)
    per pair and no panel read. ``windows`` defaults to the full sample;
    pass ``subperiod_windows(bank.n_months, pieces)`` for fresh splits. No
    QR referee runs here: ``refereed`` is always False and
    ``suspect_months`` carries the disclosure. ``estimator`` sweeps the
    banked scenarios under a bank-servable estimator cell
    (``grambank.estimator_query``: ols/fwl/iv and the month-separable
    pooled families), still without a panel contraction; absorb raises there
    (the bank holds no FE-cell stats)."""
    from fm_returnprediction_tpu_torch.specgrid.grambank import scenario_query

    label_of = ({col: label for label, col in variables_dict.items()}
                if variables_dict else None)
    return scenario_query(bank, windows=windows, bootstrap=bootstrap, seed=seed,
                          weights=weights, label_of=label_of, estimator=estimator,
                          device=device)
