"""Declarative specification grids.

A ``Spec`` names one Fama-MacBeth cell: a regressor subset (panel column
names), a stock universe (a subset-mask name), an optional sample window
(month-index range) and a free-form scenario tag. A ``SpecGrid`` is an
ordered batch of specs sharing the FM hyperparameters (NW lags / weight
scheme / min-months), solved together from one Gram contraction
(``specgrid.grams`` / ``specgrid.solve``). ``table2_grid`` reproduces Table
2's 3 models × 3 universes in model-major order; ``figure1_grid`` the
figure's 5-variable set per universe; ``product_grid`` any regressor-set ×
universe × window product. ``resolve_route`` reads the reporting-route
flag (``FMRP_SPECGRID_ROUTE``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS, MODELS, model_columns
from fm_returnprediction_tpu_torch.panel.subsets import SUBSET_ORDER

__all__ = ["Spec", "SpecGrid", "table2_grid", "figure1_grid", "product_grid",
           "resolve_route"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """One estimation cell. ``predictors`` are PANEL column names;
    ``universe`` names a subset mask; ``window`` is a half-open
    ``[start, stop)`` month-index range (None = full sample)."""

    name: str
    predictors: Tuple[str, ...]
    universe: str
    window: Optional[Tuple[int, int]] = None
    tag: str = ""

    def __post_init__(self):
        if len(set(self.predictors)) != len(self.predictors):
            raise ValueError(
                f"spec {self.name!r} repeats a predictor: {self.predictors}"
            )
        if self.window is not None:
            lo, hi = self.window
            if lo < 0 or hi < lo:
                raise ValueError(
                    f"spec {self.name!r} has malformed window {self.window}"
                )


@dataclasses.dataclass(frozen=True)
class SpecGrid:
    """An ordered batch of specs + the shared FM hyperparameters.

    ``union`` optionally pins the union-column order (a superset of every
    spec's predictors): the tile engine solves one union tensor in
    fixed-width spec batches, so every batch must agree on the column axis.
    ``None`` derives it from the specs, first seen first."""

    specs: Tuple[Spec, ...]
    nw_lags: int = 4
    min_months: int = 10
    weight: str = "reference"
    union: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if not self.specs:
            raise ValueError("a SpecGrid needs at least one spec")
        if self.union is not None:
            missing = {c for s in self.specs for c in s.predictors} - set(self.union)
            if missing:
                raise ValueError(
                    f"pinned union is missing predictor columns {sorted(missing)}")

    def __len__(self) -> int:
        return len(self.specs)

    @property
    def union_predictors(self) -> List[str]:
        """Union of every spec's predictor columns, first-seen order (or the
        pinned ``union``) — the column order of the ``x`` tensor the
        contraction reads."""
        if self.union is not None:
            return list(self.union)
        union: List[str] = []
        for spec in self.specs:
            for c in spec.predictors:
                if c not in union:
                    union.append(c)
        return union

    @property
    def universe_names(self) -> List[str]:
        """Distinct universes, first-seen order."""
        names: List[str] = []
        for spec in self.specs:
            if spec.universe not in names:
                names.append(spec.universe)
        return names

    def column_selector(self) -> np.ndarray:
        """(S, P) bool: which union columns each spec selects."""
        union = {c: i for i, c in enumerate(self.union_predictors)}
        sel = np.zeros((len(self.specs), len(union)), dtype=bool)
        for s, spec in enumerate(self.specs):
            for c in spec.predictors:
                sel[s, union[c]] = True
        return sel

    def column_positions(self, spec: Spec) -> List[int]:
        """Union-column indices of one spec's predictors, in spec order."""
        union = {c: i for i, c in enumerate(self.union_predictors)}
        return [union[c] for c in spec.predictors]

    def universe_index(self, names: Sequence[str]) -> np.ndarray:
        """(S,) index of each spec's universe within ``names``."""
        pos = {n: i for i, n in enumerate(names)}
        missing = [s.universe for s in self.specs if s.universe not in pos]
        if missing:
            raise KeyError(
                f"specs reference unknown universes {sorted(set(missing))}; "
                f"available: {list(names)}"
            )
        return np.asarray([pos[s.universe] for s in self.specs], np.int64)

    def window_masks(self, n_months: int) -> np.ndarray:
        """(S, T) bool month-inclusion masks; a window starting at or beyond
        the panel raises."""
        out = np.ones((len(self.specs), n_months), dtype=bool)
        for s, spec in enumerate(self.specs):
            if spec.window is not None:
                lo, hi = spec.window
                if lo >= n_months:
                    raise ValueError(
                        f"spec {spec.name!r} window {spec.window} starts at "
                        f"or beyond the panel's {n_months} months"
                    )
                out[s, :] = False
                out[s, lo:min(hi, n_months)] = True
        return out


def table2_grid(
    variables_dict: Dict[str, str],
    models=None,
    subsets: Sequence[str] = None,
    nw_lags: int = 4,
    min_months: int = 10,
    weight: str = "reference",
) -> SpecGrid:
    """Table 2's cells, model-major: ``specs[mi * len(subsets) + si]`` is
    (model mi, subset si)."""
    models = models if models is not None else MODELS
    subsets = list(subsets) if subsets is not None else list(SUBSET_ORDER)
    specs = []
    for model in models:
        cols = tuple(model_columns(model, variables_dict))
        for name in subsets:
            specs.append(Spec(f"{model.name} | {name}", cols, name))
    return SpecGrid(tuple(specs), nw_lags=nw_lags, min_months=min_months,
                    weight=weight)


def figure1_grid(
    subsets: Sequence[str],
    nw_lags: int = 4,
    min_months: int = 10,
    weight: str = "reference",
) -> SpecGrid:
    """The Figure-1 family: the figure's own 5-variable set per universe."""
    cols = tuple(FIGURE1_VARS.keys())
    specs = tuple(Spec(f"figure1 | {name}", cols, name) for name in subsets)
    return SpecGrid(specs, nw_lags=nw_lags, min_months=min_months,
                    weight=weight)


def product_grid(
    regressor_sets: Dict[str, Sequence[str]],
    universes: Sequence[str],
    windows: Optional[Dict[str, Optional[Tuple[int, int]]]] = None,
    tag: str = "",
    nw_lags: int = 4,
    min_months: int = 10,
    weight: str = "reference",
) -> SpecGrid:
    """Cartesian product regressor-set × universe × window → one grid."""
    windows = windows or {"full": None}
    specs = []
    for set_name, cols in regressor_sets.items():
        for universe in universes:
            for win_name, win in windows.items():
                specs.append(Spec(f"{set_name} | {universe} | {win_name}",
                                  tuple(cols), universe, window=win, tag=tag))
    return SpecGrid(tuple(specs), nw_lags=nw_lags, min_months=min_months,
                    weight=weight)


def resolve_route(
    route: Optional[str] = None,
    default: str = "gram",
    allowed: Optional[Tuple[str, ...]] = None,
) -> str:
    """The reporting-route flag: the ``route`` argument wins, then the
    ``FMRP_SPECGRID_ROUTE`` environment variable, then ``default``.
    "gram" solves the cells from shared Gram sufficient statistics;
    "stacked" is the batched-QR route under the ``reporting.fusion``
    split/fuse policy; "coreset" is the Gram route on a sampled and
    reweighted panel (``specgrid.coreset``), a disclosed approximation that
    only the scenario engine accepts: Table 2 and the figure sweep pass
    ``allowed`` and refuse it."""
    if route is None:
        route = os.environ.get("FMRP_SPECGRID_ROUTE", default)
    if route not in ("gram", "stacked", "coreset"):
        raise ValueError(
            f"route={route!r}: expected 'gram', 'stacked' or 'coreset'"
        )
    if allowed is not None and route not in allowed:
        # the paper-parity surfaces fail loudly rather than silently
        # approximate when FMRP_SPECGRID_ROUTE=coreset leaks in from a
        # scenario-sweep environment
        raise ValueError(
            f"route={route!r} is not available here (allowed: {allowed}) — "
            "the coreset tier is a disclosed approximation for the scenario "
            "engine, not the parity reporting paths"
        )
    return route
