"""Lazy, index-addressable scenario cell space — tiles, not materialized grids.

A ``CellSpace`` is the ordered dimension product

    winsor × weight × estimator × regressor-set × universe × window × draw

addressed by mixed-radix arithmetic: cell ``i`` decodes by divmod in that
(outermost → innermost) order, ``len(space)`` is a product of dimension
sizes, and nothing the size of the product is allocated. ``tiles()``
yields fixed-width contiguous index ranges; the engine
(``specgrid.engine``) solves one tile at a time and hands each tile's rows
to a streaming sink, so peak incremental memory is one tile.

The dimension order follows the execution grouping:

- ``winsor`` outermost — a new level re-clips the union tensor, so tiles
  rarely straddle a level and at most one re-winsorized variant is live;
- ``weight`` next — every NW scheme re-aggregates from one contraction and
  solve (``solve.run_spec_grid_weights``), so the engine passes the
  space's full weight tuple and slices per cell;
- ``estimator`` next — each estimator kind solves on its own route (OLS on
  the refereed grid route, the other kinds through
  ``estimators.run_estimator_grid_weights``), so grouping cells by
  estimator keeps one route per batch;
- the (set, universe, window) spec product in the middle — contiguous cell
  ranges decode to contiguous spec runs, which lets a tile chunk into
  fixed-width padded ``SpecGrid`` batches;
- ``draw`` innermost — bootstrap draws of a spec share its Gram solve and
  differ only in the month-resampled aggregation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

from fm_returnprediction_tpu_torch.specgrid.estimators.core import (
    EST_OLS,
    Estimator,
)
from fm_returnprediction_tpu_torch.specgrid.specs import Spec

__all__ = ["Cell", "CellSpace", "CellTile", "resolve_tile_cells",
           "scenario_space"]

#: default tile width (cells) — overridden by ``FMRP_SPECGRID_TILE``
DEFAULT_TILE_CELLS = 512


def resolve_tile_cells(tile_cells: Optional[int] = None) -> int:
    """Tile width: explicit argument wins, then ``FMRP_SPECGRID_TILE``,
    then the default. Must be >= 1."""
    if tile_cells is None:
        tile_cells = int(os.environ.get("FMRP_SPECGRID_TILE",
                                        DEFAULT_TILE_CELLS))
    if tile_cells < 1:
        raise ValueError(f"tile_cells must be >= 1, got {tile_cells}")
    return int(tile_cells)


class Cell(NamedTuple):
    """One decoded scenario cell — everything needed to name, solve and
    aggregate it. ``index`` is the cell's global position in the space (the
    deterministic address; sinks use it as the stable tie-breaker)."""

    index: int
    winsor: float
    weight: str
    set_name: str
    predictors: Tuple[str, ...]
    universe: str
    window_name: str
    window: Optional[Tuple[int, int]]
    draw: int
    estimator: Estimator = EST_OLS

    def spec(self, tag: str = "") -> Spec:
        """The cell's ``Spec`` (draw/winsor/weight are solve-level
        dimensions, not part of the spec identity)."""
        return Spec(
            f"{self.set_name} | {self.universe} | {self.window_name}",
            self.predictors, self.universe, window=self.window, tag=tag,
        )


@dataclasses.dataclass(frozen=True)
class CellSpace:
    """The deterministic scenario product, index-addressable and lazy.

    ``regressor_sets``/``windows`` are ordered (name, value) tuples rather
    than dicts so the space hashes and the addressing is reproducible from
    the constructor arguments alone."""

    regressor_sets: Tuple[Tuple[str, Tuple[str, ...]], ...]
    universes: Tuple[str, ...]
    windows: Tuple[Tuple[str, Optional[Tuple[int, int]]], ...]
    winsor_levels: Tuple[float, ...] = (1.0,)
    weights: Tuple[str, ...] = ("reference",)
    estimators: Tuple[Estimator, ...] = (EST_OLS,)
    bootstrap: int = 1
    nw_lags: int = 4
    min_months: int = 10
    tag: str = ""

    def __post_init__(self):
        if not (self.regressor_sets and self.universes and self.windows
                and self.winsor_levels and self.weights and self.estimators):
            raise ValueError("every CellSpace dimension needs >= 1 value")
        if self.bootstrap < 1:
            raise ValueError("bootstrap counts the draws incl. the point "
                             "estimate; must be >= 1")
        bad = [e for e in self.estimators if not isinstance(e, Estimator)]
        if bad:
            raise TypeError(
                f"estimators must be Estimator instances, got {bad} — "
                "parse spec strings with estimators.parse_estimator first"
            )

    # dimension sizes, outermost → innermost (the mixed-radix digits)
    @property
    def dims(self) -> Tuple[Tuple[str, int], ...]:
        return (
            ("winsor", len(self.winsor_levels)),
            ("weight", len(self.weights)),
            ("estimator", len(self.estimators)),
            ("set", len(self.regressor_sets)),
            ("universe", len(self.universes)),
            ("window", len(self.windows)),
            ("draw", self.bootstrap),
        )

    def __len__(self) -> int:
        n = 1
        for _, size in self.dims:
            n *= size
        return n

    @property
    def n_specs(self) -> int:
        """Size of the (set, universe, window) spec product."""
        return len(self.regressor_sets) * len(self.universes) * len(self.windows)

    @property
    def n_pairs(self) -> int:
        """Size of the (set, universe) PAIR product — the factorized
        contraction axis (``specgrid.grams.unique_pairs``): specs
        differing only in their sample window share one pair, so a
        W-window sweep contracts ``n_pairs`` spec-rows, not
        ``n_specs = n_pairs · W``."""
        return len(self.regressor_sets) * len(self.universes)

    @property
    def union_predictors(self) -> Tuple[str, ...]:
        """Union of every set's columns, first-seen order — the column
        order of the union tensor every tile contracts. Estimator aux
        columns (FWL controls, IV endogenous/instrument columns) ride the
        SAME union tensor (appended after the set columns), so estimator
        cells transform the one contraction every other cell shares."""
        union = []
        for _, cols in self.regressor_sets:
            for c in cols:
                if c not in union:
                    union.append(c)
        for e in self.estimators:
            for c in (*e.controls, *e.endog, *e.instruments):
                if c not in union:
                    union.append(c)
        return tuple(union)

    def cell(self, index: int) -> Cell:
        """Decode one global cell index (mixed-radix divmod)."""
        if not 0 <= index < len(self):
            raise IndexError(f"cell {index} outside space of {len(self)}")
        rem = index
        digits = {}
        for name, size in reversed(self.dims):
            rem, digits[name] = divmod(rem, size)
        set_name, cols = self.regressor_sets[digits["set"]]
        win_name, win = self.windows[digits["window"]]
        return Cell(
            index=index,
            winsor=self.winsor_levels[digits["winsor"]],
            weight=self.weights[digits["weight"]],
            set_name=set_name,
            predictors=cols,
            universe=self.universes[digits["universe"]],
            window_name=win_name,
            window=win,
            draw=digits["draw"],
            estimator=self.estimators[digits["estimator"]],
        )

    def estimator_index(self, index: int) -> int:
        """The cell's position in the estimator dimension — cells
        differing only in (set, universe, window, draw) share it (and
        share one estimator route inside a tile)."""
        inner = (len(self.regressor_sets) * len(self.universes)
                 * len(self.windows) * self.bootstrap)
        _, e = divmod(index // inner, len(self.estimators))
        return e

    def spec_index(self, index: int) -> int:
        """The cell's position in the (set, universe, window) spec product
        — cells differing only in winsor/weight/draw share it (and share
        one Gram solve inside a tile)."""
        n_wins, n_draw = len(self.windows), self.bootstrap
        n_uni = len(self.universes)
        rem = index // n_draw
        rem, w = divmod(rem, n_wins)
        rem, u = divmod(rem, n_uni)
        _, s = divmod(rem, len(self.regressor_sets))
        return (s * n_uni + u) * n_wins + w

    def pair_index(self, index: int) -> int:
        """The cell's position in the (set, universe) pair product — cells
        differing only in winsor/weight/WINDOW/draw share it (and, under
        the factorized route, share one panel contraction)."""
        return self.spec_index(index) // len(self.windows)

    def tiles(self, tile_cells: Optional[int] = None) -> Iterator["CellTile"]:
        """Fixed-width contiguous tiles covering the space exactly once.
        Lazy: each ``CellTile`` holds only its [start, stop) range."""
        width = resolve_tile_cells(tile_cells)
        total = len(self)
        for start in range(0, total, width):
            yield CellTile(self, start, min(start + width, total))


@dataclasses.dataclass(frozen=True)
class CellTile:
    """One contiguous [start, stop) slice of a ``CellSpace`` — the unit of
    solve-and-stream. Decoding is on demand; a tile never stores cells."""

    space: CellSpace
    start: int
    stop: int

    def __len__(self) -> int:
        return self.stop - self.start

    def cells(self) -> Iterator[Cell]:
        for i in range(self.start, self.stop):
            yield self.space.cell(i)


def scenario_space(
    variables_dict: Dict[str, str],
    universes: Sequence[str],
    n_months: int,
    models=None,
    subperiods: int = 2,
    winsor_levels: Sequence[float] = (1.0,),
    weights: Sequence[str] = ("reference",),
    estimators: Sequence[Estimator] = (EST_OLS,),
    bootstrap: int = 1,
    nw_lags: int = 4,
    min_months: int = 10,
    tag: str = "",
) -> CellSpace:
    """The scenario-sweep space: Lewellen model sets × universes ×
    subperiod windows (plus the winsor/weight/draw dimensions) — the same
    enumeration ``scenarios.run_scenarios`` used to materialize eagerly,
    now addressed lazily."""
    from fm_returnprediction_tpu_torch.models.lewellen import MODELS, model_columns
    from fm_returnprediction_tpu_torch.specgrid.scenarios import subperiod_windows

    models = models if models is not None else MODELS
    windows = tuple(subperiod_windows(n_months, subperiods).items())
    sets = tuple(
        (m.name, tuple(model_columns(m, variables_dict))) for m in models
    )
    return CellSpace(
        regressor_sets=sets,
        universes=tuple(universes),
        windows=windows,
        winsor_levels=tuple(float(v) for v in winsor_levels),
        weights=tuple(weights),
        estimators=tuple(estimators),
        bootstrap=int(bootstrap),
        nw_lags=nw_lags,
        min_months=min_months,
        tag=tag,
    )
