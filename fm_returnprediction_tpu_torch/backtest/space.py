"""Lazy, index-addressable backtest cell space — the ``CellSpace`` idiom
for the backtest.

A backtest sweep is the ordered dimension product

    scheme × estimator × regressor-set × universe × weighting

decoded by mixed-radix divmod in that (outermost → innermost) order, like
``specgrid.cellspace.CellSpace``. The order is the execution grouping:

- ``scheme`` outermost — each window scheme is one coefficient-path solve
  (``backtest.paths``), so one path solve is live at a time;
- ``estimator`` next — each estimator kind (OLS, FWL) solves its own path;
- the (set, universe) PAIR product in the middle — its flattened index IS
  the bank's pair axis (set-major, universe-minor, the ``build_bank``
  enumeration), so ``pair_index`` addresses the banked stats and the
  per-pair E[r] panel directly;
- ``weighting`` innermost — EW and VW portfolios of one cell share one
  predicted-E[r] panel.

Estimator kinds without a per-month slope path (``iv``, ``absorb``,
``pooled``) are rejected at SPACE CONSTRUCTION, before any device work.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

from fm_returnprediction_tpu_torch.backtest.paths import (
    BACKTEST_ESTIMATOR_KINDS,
    parse_scheme,
    resolve_quantiles,
    resolve_schemes,
)
from fm_returnprediction_tpu_torch.specgrid.cellspace import CellTile, resolve_tile_cells
from fm_returnprediction_tpu_torch.specgrid.estimators.core import (
    EST_OLS,
    Estimator,
    parse_estimator,
)

__all__ = ["BacktestCell", "BacktestSpace", "backtest_space"]

WEIGHTINGS = ("ew", "vw")


class BacktestCell(NamedTuple):
    """One decoded backtest cell. ``index`` is the global address (the
    sinks' deterministic tie-breaker); ``pair`` the cell's row on the
    bank's (set, universe) pair axis; ``window`` None for expanding."""

    index: int
    scheme: str
    window: Optional[int]
    estimator: Estimator
    set_name: str
    universe: str
    weighting: str
    pair: int


@dataclasses.dataclass(frozen=True)
class BacktestSpace:
    """The deterministic backtest product, index-addressable and lazy.
    ``sets``/``universes`` must enumerate the bank's pair axis exactly
    (set-major, universe-minor): :func:`backtest_space` derives them from a
    bank, and ``sweep.run_backtest`` checks a hand-built space again."""

    schemes: Tuple[str, ...]
    estimators: Tuple[Estimator, ...] = (EST_OLS,)
    sets: Tuple[str, ...] = ()
    universes: Tuple[str, ...] = ()
    weightings: Tuple[str, ...] = ("ew",)
    n_quantiles: int = 10
    min_obs: int = 50
    nw_lags: int = 4

    def __post_init__(self):
        if not (self.schemes and self.estimators and self.sets
                and self.universes and self.weightings):
            raise ValueError("every BacktestSpace dimension needs >= 1 value")
        for s in self.schemes:
            parse_scheme(s)  # loud on malformed scheme names
        bad = [e.label for e in self.estimators if e.kind not in BACKTEST_ESTIMATOR_KINDS]
        if bad:
            raise ValueError(
                f"estimator kinds without a per-month slope path cannot roll an origin: "
                f"{bad}; backtests compose {BACKTEST_ESTIMATOR_KINDS} only")
        bad_w = [w for w in self.weightings if w not in WEIGHTINGS]
        if bad_w:
            raise ValueError(f"weightings must be drawn from {WEIGHTINGS}, got {bad_w}")
        if self.n_quantiles < 2:
            raise ValueError("n_quantiles must be >= 2")

    @property
    def dims(self) -> Tuple[Tuple[str, int], ...]:
        """Dimension sizes, outermost → innermost (the mixed-radix digits)."""
        return (("scheme", len(self.schemes)), ("estimator", len(self.estimators)),
                ("set", len(self.sets)), ("universe", len(self.universes)),
                ("weighting", len(self.weightings)))

    def __len__(self) -> int:
        n = 1
        for _, size in self.dims:
            n *= size
        return n

    @property
    def n_pairs(self) -> int:
        return len(self.sets) * len(self.universes)

    def cell(self, index: int) -> BacktestCell:
        """Decode one global cell index (mixed-radix divmod)."""
        if not 0 <= index < len(self):
            raise IndexError(f"cell {index} outside space of {len(self)}")
        rem = index
        digits = {}
        for name, size in reversed(self.dims):
            rem, digits[name] = divmod(rem, size)
        scheme = self.schemes[digits["scheme"]]
        return BacktestCell(
            index=index, scheme=scheme, window=parse_scheme(scheme)[1],
            estimator=self.estimators[digits["estimator"]],
            set_name=self.sets[digits["set"]], universe=self.universes[digits["universe"]],
            weighting=self.weightings[digits["weighting"]],
            pair=digits["set"] * len(self.universes) + digits["universe"])

    def pair_index(self, index: int) -> int:
        """The cell's row on the bank's pair axis: cells differing only in
        scheme/estimator/weighting share it."""
        rem = index // len(self.weightings)
        rem, u = divmod(rem, len(self.universes))
        _, s = divmod(rem, len(self.sets))
        return s * len(self.universes) + u

    def path_key(self, index: int) -> Tuple[int, int]:
        """The (scheme, estimator) digit pair: cells sharing it share ONE
        coefficient-path solve."""
        rem = index // (len(self.sets) * len(self.universes) * len(self.weightings))
        rem, e = divmod(rem, len(self.estimators))
        _, s = divmod(rem, len(self.schemes))
        return s, e

    def tiles(self, tile_cells: Optional[int] = None) -> Iterator[CellTile]:
        """Fixed-width contiguous tiles covering the space exactly once
        (``FMRP_SPECGRID_TILE`` sizing, one tile knob for both sweeps)."""
        width = resolve_tile_cells(tile_cells)
        total = len(self)
        for start in range(0, total, width):
            yield CellTile(self, start, min(start + width, total))


def backtest_space(
    bank,
    schemes=None,
    estimators: Sequence = (EST_OLS,),
    weightings: Sequence[str] = ("ew", "vw"),
    n_quantiles: Optional[int] = None,
    min_obs: int = 50,
    nw_lags: Optional[int] = None,
) -> BacktestSpace:
    """The backtest space OVER A BANK: the (set, universe) dimensions are
    derived from, and checked against, the bank's pair axis, so
    ``cell.pair`` addresses the banked stats. ``schemes`` and
    ``n_quantiles`` resolve through the ``FMRP_BACKTEST_*`` knobs;
    estimators may be ``Estimator`` values or grammar strings."""
    sets, universes = [], []
    for set_name, uni in bank.pair_labels:
        if set_name not in sets:
            sets.append(set_name)
        if uni not in universes:
            universes.append(uni)
    if tuple((s, u) for s in sets for u in universes) != tuple(bank.pair_labels):
        raise ValueError("bank pair axis is not a set-major (set × universe) product — got "
                         f"{bank.pair_labels}; backtest cells cannot address it")
    ests = tuple(e if isinstance(e, Estimator) else parse_estimator(str(e))
                 for e in estimators)
    return BacktestSpace(
        schemes=tuple(n for n, _ in resolve_schemes(schemes)), estimators=ests,
        sets=tuple(sets), universes=tuple(universes), weightings=tuple(weightings),
        n_quantiles=resolve_quantiles(n_quantiles), min_obs=int(min_obs),
        nw_lags=int(bank.meta.get("nw_lags", 4) if nw_lags is None else nw_lags))
