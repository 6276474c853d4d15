"""The tile engine: lazy cell enumeration → tile solves → sinks.

``run_cellspace`` walks a ``CellSpace`` tile by tile, solves each tile's
distinct specs through ``solve.run_spec_grid_weights`` (one Gram
contraction and solve per spec batch, every NW weight scheme aggregated
from it), expands the solve into per-cell rows — weight schemes are slices
of the same solve, bootstrap draws are month-block re-aggregations of the
same per-spec slope series — and streams every tile's rows into a sink
(``specgrid.sinks``). The engine holds one tile of specs, solve leaves and
result rows at a time. With tracing armed the sweep is a
``specgrid.cellspace`` span with one ``specgrid.tile`` span per tile, and
``fmrp_specgrid_cells_total`` counts the cells streamed.

Every tile solves in fixed-width spec batches (``spec_pad``), padded by
repeating the batch's first spec, against the space's pinned union-column
order and its full weight tuple; on the factorized route the pair axis is
padded to one width for the whole sweep (``pair_pad``), so every batch
contracts the same shape.

Routes: ``"gram"`` (exact; the default) and ``"coreset"`` (the sampled and
reweighted approximation, ``specgrid.coreset``: each cell discloses its
realized sampling rate, and the QR referee is off). Under
``precision="bf16"`` every row discloses ``bf16_promoted_months``, the
months the conditioning referee sent back to the full-precision route.

Estimators: each batch solves under one estimator. OLS rides the refereed
grid route untouched; every other kind (FWL, absorbed FE, IV, pooled; the
FM kinds under the ``nw``/``iid``/``cluster`` tails) goes through
``estimators.run_estimator_grid_weights``, and its rows add ``estimator``,
``se_family``, ``suspect_months`` and, for absorb, ``absorb_iters`` and
``absorb_converged``. The validations are loud and up front, with the
reference's exception types: OLS cells must ride the NW tail, pooled cells
need ``bootstrap=1``, bootstrap draws need ``se="nw"``, absorb needs
``fe_codes`` (KeyError).

The engine runs on one device in one process or, with
``FMRP_SPECGRID_PROCS`` > 1, its OLS batches contract across that many
worker processes (``specgrid.multiproc``), or, with ``mesh=`` or
``FMRP_SPECGRID_MESH`` (``sharded.resolve_specgrid_mesh``), over a device
mesh (``specgrid.sharded``: firm-sharded contraction, spec-sharded solve).
The estimator kinds beyond OLS and the factorized route are single-device,
as in the reference: a multi-process or mesh sweep with them raises up
front.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.specgrid.boot import (
    bootstrap_aggregate_device,
    resample_matrix,
)
from fm_returnprediction_tpu_torch.specgrid.cellspace import (
    Cell,
    CellSpace,
    CellTile,
    resolve_tile_cells,
)
from fm_returnprediction_tpu_torch.specgrid.grams import (
    resolve_gram_factorize,
    resolve_gram_precision,
)
from fm_returnprediction_tpu_torch.specgrid.estimators.grid import run_estimator_grid_weights
from fm_returnprediction_tpu_torch.specgrid.sinks import Sink, resolve_sink
from fm_returnprediction_tpu_torch.specgrid.sharded import (
    placed_panel_scope,
    resolve_specgrid_mesh,
)
from fm_returnprediction_tpu_torch.specgrid.solve import (
    contraction_counts,
    resolve_specgrid_procs,
    run_spec_grid_weights,
)
from fm_returnprediction_tpu_torch.specgrid.specs import SpecGrid

__all__ = ["run_cellspace", "block_bootstrap_months"]


def block_bootstrap_months(t: int, draw: int, seed: int = 0,
                           block: Optional[int] = None) -> np.ndarray:
    """Deterministic circular moving-block month resample for one draw.

    All cells of a draw share one resample (the paired bootstrap); draw 0
    is the point estimate and never resampled. The block length defaults
    to 6 (at least the default NW lag window)."""
    if draw < 1:
        raise ValueError("draw 0 is the point estimate; draws start at 1")
    block = block or 6
    rng = np.random.default_rng((int(seed), int(draw)))
    n_blocks = math.ceil(t / block)
    starts = rng.integers(0, t, n_blocks)
    idx = (starts[:, None] + np.arange(block)[None, :]).reshape(-1) % t
    return idx[:t]


def _winsor_groups(tile: CellTile) -> Iterator[Tuple[float, List[Cell]]]:
    """Split a tile's cells into contiguous same-winsor runs (winsor is the
    outermost dimension, so a tile straddles at most a few)."""
    cells: List[Cell] = []
    for cell in tile.cells():
        if cells and cell.winsor != cells[-1].winsor:
            yield cells[-1].winsor, cells
            cells = []
        cells.append(cell)
    if cells:
        yield cells[-1].winsor, cells


class _TileSolver:
    """Solves one winsor group's distinct (estimator, spec) cells in fixed
    ``spec_pad``-wide batches and serves per-cell views."""

    def __init__(self, engine: "_Engine", x_level, cells: List[Cell]):
        self.engine = engine
        space = engine.space
        seen: Dict[Tuple[int, int], Cell] = {}
        for c in cells:
            seen.setdefault((space.estimator_index(c.index), space.spec_index(c.index)), c)
        self.spec_rows: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.results: List[Dict[str, object]] = []
        self.disclosures: List[Optional[dict]] = []
        # each batch holds one estimator's cells
        groups: Dict[int, List[Tuple[int, int]]] = {}
        for key in seen:
            groups.setdefault(key[0], []).append(key)
        pad = engine.spec_pad
        for eidx, keys in groups.items():
            for start in range(0, len(keys), pad):
                block_keys = keys[start:start + pad]
                for row, key in enumerate(block_keys):
                    self.spec_rows[key] = (len(self.results), row)
                # pad to the fixed batch width by repeating the block's first
                # spec; padded rows are never read back
                padded = block_keys + [block_keys[0]] * (pad - len(block_keys))
                grid = SpecGrid(
                    tuple(seen[key].spec(tag=space.tag) for key in padded),
                    nw_lags=space.nw_lags, min_months=space.min_months,
                    union=space.union_predictors,
                )
                res, disc = engine.solve_block(grid, x_level, space.estimators[eidx])
                self.results.append(res)
                self.disclosures.append(disc)

    def cell_view(self, cell: Cell):
        """(per-weight SpecGridResult, local spec row, block disclosures or
        None) for one cell."""
        space = self.engine.space
        b, row = self.spec_rows[(space.estimator_index(cell.index),
                                 space.spec_index(cell.index))]
        return self.results[b][cell.weight], row, self.disclosures[b]


class _Engine:
    def __init__(self, y, x, universe_masks, space: CellSpace, *,
                 mask, route: str, mesh, referee: bool, firm_chunk, label_of,
                 seed: int, coreset_m, coreset_budget_mb, tile_cells,
                 precision=None, factorize=None, fe_codes=None):
        # resolved once per sweep: a knob flipped mid-sweep would splice two
        # numerics regimes into one result frame
        self.precision = resolve_gram_precision(precision)
        self.mesh = resolve_specgrid_mesh(mesh, device=y.device.type)
        self.space = space
        self.union = space.union_predictors
        self.y = y
        self.x_base = x
        if x.shape[-1] != len(self.union):
            raise ValueError(
                f"x holds {x.shape[-1]} columns but the space's union has "
                f"{len(self.union)} ({list(self.union)}) — slice the union tensor "
                "in space.union_predictors order")
        self.device = y.device
        self.mask = mask
        self.universe_masks = {n: torch.as_tensor(m, device=self.device)
                               for n, m in universe_masks.items()}
        self.referee = referee
        self.firm_chunk = firm_chunk
        self.label_of = label_of or {}
        self.seed = int(seed)
        self.route = route
        self._union_pos = {c: i for i, c in enumerate(self.union)}
        # the estimator dimension, validated loudly up front rather than S
        # tiles into the sweep
        self.fe_codes = fe_codes
        self.emit_estimator = len(space.estimators) > 1 or any(
            e.kind != "ols" or e.se != "nw" for e in space.estimators)
        ols_odd = [e for e in space.estimators if e.kind == "ols" and e.se != "nw"]
        if ols_odd:
            raise ValueError(
                f"OLS cells ride the incumbent NW grid tail; se families "
                f"{[e.se for e in ols_odd]} are estimator-subsystem tails — query the gram "
                "bank instead (grambank.estimator_query serves ols under the iid/clustered "
                "tails)")
        single_device = self.mesh is None and resolve_specgrid_procs(None) == 1
        non_ols = [e for e in space.estimators if e.kind != "ols"]
        if non_ols and not single_device:
            raise ValueError(
                "estimator kinds beyond OLS are a single-device route — the mesh and "
                "multi-process grid programs predate the estimator transforms (space has "
                f"{non_ols})")
        if any(e.kind == "pooled" for e in non_ols) and space.bootstrap > 1:
            raise ValueError(
                "pooled estimator cells produce no per-month slope series to resample — a "
                "pooled space must have bootstrap=1")
        if space.bootstrap > 1 and any(e.se != "nw" for e in non_ols):
            raise ValueError(
                "bootstrap draws re-aggregate the slope series under the NW tail; estimator "
                "cells with se != 'nw' cannot ride them — drop the draws or use se='nw'")
        for e in non_ols:
            if e.kind == "absorb":
                missing = [nm for nm in e.absorb if nm not in (fe_codes or {})]
                if missing:
                    raise KeyError(
                        f"estimator {e.label!r} needs FE codes for {missing} — pass "
                        "fe_codes={name: (T, N) int codes} to run_cellspace")
        # tile width rounds UP to a multiple of the draw count, so a spec's
        # draw run never straddles two tiles
        want = resolve_tile_cells(tile_cells)
        self.tile_cells = min(len(space),
                              math.ceil(want / space.bootstrap) * space.bootstrap)
        self.spec_pad = min(space.n_specs,
                            max(1, math.ceil(self.tile_cells / space.bootstrap)))
        # month-axis factorization, resolved once per sweep: "auto" turns on
        # when the space repeats (universe, col_sel) pairs across windows.
        # Any run of spec_pad consecutive spec indices (windows innermost)
        # spans at most (spec_pad-1)//n_windows + 2 pairs, so one padded
        # pair width serves every batch
        fact = resolve_gram_factorize(factorize)
        if fact == "on" and not single_device:
            raise ValueError(
                "factorize='on' is a single-device route — the mesh and multi-process "
                "contractions keep the window term in validity (specgrid.solve docstring)")
        if fact == "auto":
            fact = "on" if single_device and len(space.windows) > 1 else "off"
        self.gram_factorize = fact
        self.pair_pad = (min(self.spec_pad, (self.spec_pad - 1) // len(space.windows) + 2,
                             space.n_pairs)
                         if fact == "on" else None)
        self._boot_cache: Dict[Tuple[int, str], tuple] = {}
        self._resample_mat: Optional[np.ndarray] = None
        self._winsor_cache: Optional[Tuple[float, torch.Tensor]] = None
        self._rate_cache: Dict[Tuple[str, Optional[Tuple[int, int]]], float] = {}

        self.plan = None
        self.row_weights = None
        if route == "coreset":
            from fm_returnprediction_tpu_torch.specgrid.coreset import (
                coreset_plan,
                resolve_coreset_m,
            )

            t, n = y.shape
            m = resolve_coreset_m(n, coreset_m, coreset_budget_mb, t=t,
                                  q=len(self.union) + 1, itemsize=x.element_size())
            y_np = y.detach().cpu().numpy()
            base_mask = (np.asarray(mask, bool) if mask is not None
                         else np.isfinite(y_np))
            self.plan = coreset_plan(y_np, x.detach().cpu().numpy(), base_mask, m,
                                     seed=self.seed)
            self.row_weights = torch.as_tensor(self.plan.row_weights,
                                               device=self.device).to(x.dtype)
        elif route != "gram":
            raise ValueError(f"the tile engine solves route='gram' or 'coreset', got {route!r}")

    def x_at_level(self, level: float) -> torch.Tensor:
        """The union tensor re-winsorized at ``level``, one level cached
        (winsor is the outermost dimension; levels arrive contiguously).
        The previous level's variant, when it is not the base tensor, is
        the buffer the next one is written into, so at most two union
        tensors are live."""
        if self._winsor_cache is not None and self._winsor_cache[0] == level:
            return self._winsor_cache[1]
        scratch = None
        if self._winsor_cache is not None and self._winsor_cache[1] is not self.x_base:
            scratch = self._winsor_cache[1]
        self._winsor_cache = None
        if level == 1.0:
            x_level = self.x_base
        else:
            from fm_returnprediction_tpu_torch.specgrid.scenarios import winsor_variant

            if self.mask is None:
                raise ValueError("winsor levels beyond the stored base clip need the "
                                 "panel validity mask (mask=...)")
            x_level = winsor_variant(self.x_base,
                                     torch.as_tensor(self.mask, device=self.device),
                                     float(level), scratch=scratch)
        del scratch
        self._winsor_cache = (level, x_level)
        return x_level

    def solve_block(self, grid: SpecGrid, x_level, estimator):
        """One padded spec batch under one estimator: ``(every weight
        scheme's SpecGridResult, disclosures or None)``. OLS rides the
        refereed grid route; the other kinds the estimator route."""
        if estimator.kind == "ols":
            return run_spec_grid_weights(
                self.y, x_level, self.universe_masks, grid, self.space.weights,
                referee=self.referee, firm_chunk=self.firm_chunk, mesh=self.mesh,
                row_weights=self.row_weights, precision=self.precision,
                factorize=self.gram_factorize, pair_pad=self.pair_pad,
            ), None
        return run_estimator_grid_weights(
            estimator, self.y, x_level, self.universe_masks, grid, self.space.weights,
            firm_chunk=self.firm_chunk, row_weights=self.row_weights,
            precision=self.precision, factorize=self.gram_factorize,
            pair_pad=self.pair_pad, fe_codes=self.fe_codes,
        )

    def resamples(self) -> np.ndarray:
        """The (draws-1, T) resample stack every cell of the sweep shares."""
        if self._resample_mat is None:
            self._resample_mat = resample_matrix(int(self.y.shape[0]), self.space.bootstrap,
                                                 seed=self.seed)
        return self._resample_mat

    def boot_draws(self, cell: Cell, res, row: int) -> tuple:
        """Every bootstrap draw of one (spec, weight, winsor) run at once on
        the device, cached for the run's remaining cells (draws are the
        innermost dimension, so the cache is cleared at tile boundaries)."""
        key = (cell.index - cell.draw, cell.weight)
        out = self._boot_cache.get(key)
        if out is None:
            out = bootstrap_aggregate_device(
                res.slopes[row], res.r2[row], res.n_obs[row], res.month_valid[row],
                self.resamples(), self.space.nw_lags, self.space.min_months,
                cell.weight, device=self.device,
            )
            self._boot_cache[key] = out
        return out

    def coreset_rate(self, cell: Cell) -> float:
        key = (cell.universe, cell.window)
        rate = self._rate_cache.get(key)
        if rate is None:
            t = int(self.y.shape[0])
            win = None
            if cell.window is not None:
                win = np.zeros(t, bool)
                win[cell.window[0]:min(cell.window[1], t)] = True
            rate = self.plan.rate_under(
                self.universe_masks[cell.universe].cpu().numpy().astype(bool), win)
            self._rate_cache[key] = rate
        return rate

    def rows_for(self, cell: Cell, res, row: int, disc: Optional[dict] = None) -> List[dict]:
        space = self.space
        preds = cell.predictors
        if cell.estimator.kind == "fwl":
            # a control inside the cell's focal set is partialled OUT of the
            # solve, so its slot holds padding, not a coefficient
            dropped = set(cell.estimator.controls)
            preds = tuple(c for c in preds if c not in dropped)
        pos = [self._union_pos[c] for c in preds]
        if cell.draw == 0:
            coef, tstat, nw_se = res.coef[row], res.tstat[row], res.nw_se[row]
            mean_r2 = float(res.mean_r2[row])
            mean_n = float(res.mean_n[row])
            n_months = int(res.n_months[row])
        else:
            d = cell.draw - 1  # draw rows start at draw 1
            coef_d, tstat_d, nw_d, r2_d, n_d, m_d = self.boot_draws(cell, res, row)
            coef_c, tstat_c, nw_c = coef_d[d], tstat_d[d], nw_d[d]
            mean_r2, mean_n, n_months = float(r2_d[d]), float(n_d[d]), int(m_d[d])
            coef = np.full(len(self.union), np.nan)
            tstat = np.full(len(self.union), np.nan)
            nw_se = np.full(len(self.union), np.nan)
            coef[pos] = coef_c[pos]
            tstat[pos] = tstat_c[pos]
            nw_se[pos] = nw_c[pos]
        refereed = row in res.referee_specs
        rows = []
        for col, p in zip(preds, pos):
            r = {
                "cell": cell.index,
                "model": cell.set_name,
                "universe": cell.universe,
                "window": cell.window_name,
                "winsor_pct": float(cell.winsor),
                "nw_weight": cell.weight,
                "predictor": self.label_of.get(col, col),
                "coef": float(coef[p]),
                "tstat": float(tstat[p]),
                "nw_se": float(nw_se[p]),
                "mean_r2": mean_r2,
                "mean_n": mean_n,
                "n_months": n_months,
                "refereed": refereed,
            }
            if self.emit_estimator:
                # estimator cells disclose, never referee: the label, the SE
                # family, the conditioning disclosure and (absorb) the
                # alternating projections' convergence account
                r["estimator"] = cell.estimator.label
                r["se_family"] = cell.estimator.se
                if cell.estimator.kind != "ols":
                    r["suspect_months"] = int(res.suspect_months[row])
                if disc is not None and "absorb_iters" in disc:
                    r["absorb_iters"] = int(disc["absorb_iters"][row])
                    r["absorb_converged"] = bool(disc["absorb_converged"][row])
            if space.bootstrap > 1:
                r["draw"] = cell.draw
            if self.precision == "bf16":
                # the months the conditioning referee promoted back to the
                # full-precision QR route (``refereed`` says whether it ran)
                r["precision"] = "bf16"
                r["bf16_promoted_months"] = int(res.suspect_months[row])
            if self.route == "coreset":
                r["route"] = "coreset"
                r["coreset_m"] = self.plan.m_per_month
                r["coreset_rate"] = self.coreset_rate(cell)
                r["suspect_months"] = int(res.suspect_months[row])
            rows.append(r)
        return rows


def run_cellspace(
    y: torch.Tensor,
    x: torch.Tensor,
    universe_masks: Dict[str, object],
    space: CellSpace,
    sink=None,
    tile_cells: Optional[int] = None,
    route: str = "gram",
    mesh=None,
    referee: bool = True,
    mask=None,
    firm_chunk: Optional[int] = None,
    label_of: Optional[Dict[str, str]] = None,
    seed: int = 0,
    coreset_m: Optional[int] = None,
    coreset_budget_mb: Optional[float] = None,
    output_dir=None,
    precision: Optional[str] = None,
    factorize: Optional[str] = None,
    fe_codes: Optional[Dict[str, object]] = None,
):
    """Stream a ``CellSpace`` sweep through a sink.

    ``y`` (T, N) and ``x`` (T, N, len(space.union_predictors)) are tensors
    on the compute device, ``x`` in ``space.union_predictors`` order;
    ``universe_masks`` covers every universe the space names; ``mask`` (T,
    N) is the panel's validity (needed by winsor levels and the coreset
    plan). ``sink`` is a ``Sink``, a sink name (``sinks.SINK_NAMES``), or
    None (the ``FMRP_SPECGRID_SINK``/``"frame"`` default). ``fe_codes``
    maps FE names → (T, N) int code arrays for spaces carrying ``absorb``
    estimator cells. Returns
    ``(sink.finish(), stats)`` where the stats disclose
    cells/rows/tiles/seconds and the contraction work.
    """
    sink_obj: Sink = resolve_sink(sink, output_dir=output_dir)
    engine = _Engine(
        y, x, universe_masks, space, mask=mask, route=route, mesh=mesh,
        referee=referee, firm_chunk=firm_chunk, label_of=label_of, seed=seed,
        coreset_m=coreset_m, coreset_budget_mb=coreset_budget_mb,
        tile_cells=tile_cells, precision=precision, factorize=factorize,
        fe_codes=fe_codes,
    )
    before = contraction_counts()
    cells_counter = telemetry.registry().counter(
        "fmrp_specgrid_cells_total",
        help="scenario cells streamed through the spec-grid tile engine",
    )
    n_tiles = 0
    # the mesh route keeps its placed panel for this sweep's tiles only
    with placed_panel_scope(), telemetry.timed("specgrid.cellspace", cells=len(space),
                                               tile=engine.tile_cells, route=route) as sweep_t:
        for tile in space.tiles(engine.tile_cells):
            with telemetry.span("specgrid.tile", start=tile.start, stop=tile.stop):
                frames: List[dict] = []
                for level, cells in _winsor_groups(tile):
                    solver = _TileSolver(engine, engine.x_at_level(level), cells)
                    for cell in cells:
                        res, row, disc = solver.cell_view(cell)
                        frames.extend(engine.rows_for(cell, res, row, disc))
                    del solver  # one tile of solve leaves live at a time
                engine._boot_cache.clear()  # draw runs never straddle tiles
                sink_obj.consume(pd.DataFrame(frames))
                cells_counter.inc(len(tile))
            n_tiles += 1
    seconds = sweep_t.s
    after = contraction_counts()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("specs_solved", "specs_contracted", "pairs_contracted", "pairs_unique")}
    stats = {
        "cells": len(space),
        "rows": sink_obj.rows_seen,
        "tiles": n_tiles,
        "tile_cells": engine.tile_cells,
        "spec_pad": engine.spec_pad,
        "seconds": seconds,
        "cells_per_s": len(space) / seconds if seconds > 0 else None,
        "route": route,
        "precision": engine.precision,
        "gram_factorize": engine.gram_factorize,
        "specs_solved": delta["specs_solved"],
        "specs_contracted": (delta["pairs_contracted"] if engine.gram_factorize == "on"
                             else delta["specs_contracted"]),
        "pairs_unique": delta["pairs_unique"],
        "pair_pad": engine.pair_pad,
    }
    if engine.plan is not None:
        stats["coreset_m"] = engine.plan.m_per_month
        stats["coreset_exact_months"] = engine.plan.exact_months
    return sink_obj.finish(), stats
