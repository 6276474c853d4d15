"""Declarative specification grids.

A ``Spec`` names one Fama-MacBeth cell: a regressor subset (panel column
names), a stock universe (a subset-mask name) and an optional sample window
(month-index range). A ``SpecGrid`` is an ordered batch of specs sharing the
FM hyperparameters (NW lags / weight scheme / min-months), solved together
from one Gram contraction (``specgrid.grams`` / ``specgrid.solve``).
``table2_grid`` reproduces Table 2's 3 models × 3 universes in model-major
order; ``figure1_grid`` the figure's 5-variable set per universe.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS, MODELS, model_columns
from fm_returnprediction_tpu_torch.panel.subsets import SUBSET_ORDER

__all__ = ["Spec", "SpecGrid", "table2_grid", "figure1_grid"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """One estimation cell. ``predictors`` are PANEL column names;
    ``universe`` names a subset mask; ``window`` is a half-open
    ``[start, stop)`` month-index range (None = full sample)."""

    name: str
    predictors: Tuple[str, ...]
    universe: str
    window: Optional[Tuple[int, int]] = None

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
    """An ordered batch of specs + the shared FM hyperparameters."""

    specs: Tuple[Spec, ...]
    nw_lags: int = 4
    min_months: int = 10
    weight: str = "reference"

    def __post_init__(self):
        if not self.specs:
            raise ValueError("a SpecGrid needs at least one spec")

    def __len__(self) -> int:
        return len(self.specs)

    @property
    def union_predictors(self) -> List[str]:
        """Union of every spec's predictor columns, first-seen order — the
        column order of the ``x`` tensor the contraction reads."""
        union: List[str] = []
        for spec in self.specs:
            for c in spec.predictors:
                if c not in union:
                    union.append(c)
        return union

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
