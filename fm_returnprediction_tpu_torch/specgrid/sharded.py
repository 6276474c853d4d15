"""The spec grid on a device mesh: firm-sharded contraction, spec-sharded
solve.

Two stages over ONE 1-D mesh axis (``parallel.partition.specgrid_axis``):

1. **Contraction.** The (T, N, P) panel shards over firms. Two ``psum``\\ s
   of the shards' masked column sums and counts give the global per-month
   center, so every shard contracts against the same shift (the
   precondition of the Gram stats' additivity over firms); each shard runs
   ``grams.contract_spec_grams(center=…)`` on its device — on the card one
   Gram-kernel launch per shard — and one ``psum`` of the additive leaves
   (gram, moment, n, Σy, Σy²) gives the global stats.
2. **Solve.** The (S, T, Q, Q) stats re-place spec-sharded: the spec axis
   pads to the mesh with intercept-only ghost specs (zero stats, so
   ``month_valid`` is all False and they solve to exact zeros), each shard
   runs ``solve._solve_and_aggregate`` on its specs, the ghost specs are
   dropped, and the guard sentinels' per-shard counters are summed.

Every placement comes from the rule tables of ``parallel.partition``,
matched against the named argument tree, never threaded by hand. The sums
run in another order than the one-device contraction, so the mesh matches
it to the differential tolerances (≤1e-6), not bit for bit.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch

from fm_returnprediction_tpu_torch.parallel.mesh import (
    local_devices,
    make_mesh,
    pad_to_multiple,
    place_global,
    psum,
)
from fm_returnprediction_tpu_torch.parallel.partition import (
    specgrid_axis,
    specgrid_panel_rules,
    specgrid_stats_rules,
    tree_shardings,
)
from fm_returnprediction_tpu_torch.specgrid.grams import (
    SpecGramStats,
    auto_firm_chunk,
    contract_spec_grams,
)

__all__ = ["placed_panel_scope", "resolve_specgrid_mesh", "sharded_grid_parts", "specgrid_mesh"]


def specgrid_mesh(n_devices: Optional[int] = None, device=None):
    """A 1-D mesh over ``n_devices`` of ``local_devices(device)``, named
    with the spec-grid axis."""
    return make_mesh(n_devices=n_devices, axis_name=specgrid_axis(), device=device)


def resolve_specgrid_mesh(mesh=None, device=None):
    """The spec-grid mesh policy: an explicit ``mesh`` wins, then
    ``FMRP_SPECGRID_MESH``: unset/``0``/``1`` → None (one device),
    ``auto`` → every local device of ``device``'s kind (None with one),
    ``N`` → exactly N, raising when there are fewer."""
    if mesh is not None:
        return mesh
    want = os.environ.get("FMRP_SPECGRID_MESH", "").strip().lower()
    if want in ("", "0", "1"):
        return None
    if want == "auto":
        n = len(local_devices(device))
        return specgrid_mesh(n, device=device) if n > 1 else None
    n = int(want)
    return specgrid_mesh(n, device=device) if n > 1 else None


# single-slot memo of the padded, placed panel, alive inside
# ``placed_panel_scope``: the tile engine calls the mesh route once per spec
# batch with the same panel tensors (only the per-spec selectors change),
# and re-placing the (T, N, P) union tensor per batch would copy it every
# time. Keyed by the mesh and the input tensors' identities and versions (an
# in-place update re-places); the entry holds the tensors, so the identities
# stay valid. Outside a scope nothing is kept, so no shard copy outlives the
# grid that placed it.
_PLACED_PANEL_CACHE: Optional[tuple] = None
_SCOPE_DEPTH = 0


@contextlib.contextmanager
def placed_panel_scope():
    """Keep the last placed panel for the mesh grids run inside the block,
    and drop it when the outermost block ends."""
    global _PLACED_PANEL_CACHE, _SCOPE_DEPTH
    _SCOPE_DEPTH += 1
    try:
        yield
    finally:
        _SCOPE_DEPTH -= 1
        if _SCOPE_DEPTH == 0:
            _PLACED_PANEL_CACHE = None


def _placed_panel(mesh, y, x, universe_list, row_weights):
    global _PLACED_PANEL_CACHE

    def tag(a):
        return None if a is None else (id(a), getattr(a, "_version", None))

    key = (mesh, tag(y), tag(x), tuple(tag(u) for u in universe_list), tag(row_weights))
    cached = _PLACED_PANEL_CACHE
    if cached is not None and cached[0] == key:
        return cached[2]
    axis = mesh.axis_names[0]
    d = int(mesh.shape[axis])
    universes = torch.stack([torch.as_tensor(u, device=y.device) for u in universe_list])
    tree = {
        "y": pad_to_multiple(y, 1, d, float("nan")),
        "x": pad_to_multiple(x, 1, d, float("nan")),
        "universes": pad_to_multiple(universes, 2, d, False),
    }
    if row_weights is not None:
        tree["row_weights"] = pad_to_multiple(
            torch.as_tensor(row_weights, device=y.device).to(x.dtype), 1, d, 0.0)
    shardings = tree_shardings(mesh, specgrid_panel_rules(axis), tree)
    placed = {k: place_global(v, shardings[k]) for k, v in tree.items()}
    _PLACED_PANEL_CACHE = (None if _SCOPE_DEPTH == 0 else
                           (key, (y, x, tuple(universe_list), row_weights), placed))
    return placed


def _contract(mesh, placed, uidx, col_sel, window, firm_chunk) -> SpecGramStats:
    """Stage 1 (module docstring): the global center, one contraction per
    shard, one psum of the additive leaves. Returns the stats on the first
    shard's device."""
    axis = mesh.axis_names[0]
    xs = placed["x"].shards
    fin = [torch.isfinite(xl) for xl in xs]
    s_glob = psum(mesh, [torch.where(f, xl, torch.zeros_like(xl)).sum(dim=1)
                         for f, xl in zip(fin, xs)], axis)
    c_glob = psum(mesh, [f.sum(dim=1) for f in fin], axis)
    rws = placed["row_weights"].shards if "row_weights" in placed else [None] * len(xs)
    parts = []
    for dev, yl, xl, ul, rw, s, c in zip(mesh.local_devices(), placed["y"].shards, xs,
                                         placed["universes"].shards, rws, s_glob, c_glob):
        center = s / torch.clamp_min(c, 1).to(xl.dtype)
        stats = contract_spec_grams(yl, xl, ul, uidx.to(dev), col_sel.to(dev), window.to(dev),
                                    firm_chunk=firm_chunk, center=center, row_weights=rw,
                                    expect_shared_center=True)
        parts.append((stats.gram, stats.moment, stats.n, stats.ysum, stats.yy, center))
    summed = psum(mesh, [p[:5] for p in parts], axis)[0]
    return SpecGramStats(*summed, parts[0][5])


def sharded_grid_parts(
    y: torch.Tensor,
    x: torch.Tensor,
    universes: Tuple[torch.Tensor, ...],
    uidx: torch.Tensor,
    col_sel: torch.Tensor,
    window: torch.Tensor,
    *,
    mesh,
    row_weights=None,
    nw_lags: int,
    min_months: int,
    weights: Tuple[str, ...],
    firm_chunk: Optional[int],
    guard: bool,
):
    """The mesh route of ``solve.run_spec_grid_weights``: the same ``(cs,
    fms, suspect, counters)`` as ``solve._solve_and_aggregate`` over the
    whole grid (counters None without ``guard``), computed as the
    firm-sharded contraction → psum → spec-sharded solve (module
    docstring). ``universes`` holds the (T, N) universe masks in
    ``uidx`` order. Leaves land on the mesh's first device."""
    from fm_returnprediction_tpu_torch.specgrid.solve import _solve_and_aggregate

    if len(mesh.axis_names) != 1:
        raise ValueError(f"spec-grid sharding wants a 1-D mesh, got axes {mesh.axis_names}")
    axis = mesh.axis_names[0]
    d = int(mesh.shape[axis])
    t, _, p = x.shape
    s_specs = int(col_sel.shape[0])

    placed = _placed_panel(mesh, y, x, universes, row_weights)
    n_local = placed["y"].shards[0].shape[1]
    chunk = min(firm_chunk or auto_firm_chunk(t, n_local, p + 1, x.element_size()), n_local)
    stats = _contract(mesh, placed, uidx, col_sel, window, chunk)

    # ghost specs pad S to the mesh: intercept-only selector, zero stats
    solve_tree = {name: pad_to_multiple(getattr(stats, name), 0, d, 0.0)
                  for name in ("gram", "moment", "n", "ysum", "yy")}
    solve_tree["center"] = stats.center
    solve_tree["col_sel"] = pad_to_multiple(col_sel.to(stats.gram.device), 0, d, False)
    shardings = tree_shardings(mesh, specgrid_stats_rules(axis), solve_tree)
    placed_stats = {k: place_global(v, shardings[k]) for k, v in solve_tree.items()}
    outs = []
    for i in range(len(mesh.local_positions())):
        shard_stats = SpecGramStats(*(placed_stats[k].shards[i]
                                      for k in ("gram", "moment", "n", "ysum", "yy", "center")))
        outs.append(_solve_and_aggregate(
            shard_stats, placed_stats["col_sel"].shards[i], y.dtype, nw_lags=nw_lags,
            min_months=min_months, weights=tuple(weights), guard=guard))
    home = stats.gram.device

    def cat(leaves):
        return torch.cat([leaf.to(home) for leaf in leaves], dim=0)[:s_specs]

    cs = type(outs[0][0])(*(cat(leaves) for leaves in zip(*(o[0] for o in outs))))
    fms = tuple(type(fm0)(*(cat(leaves) for leaves in zip(*(o[1][w] for o in outs))))
                for w, fm0 in enumerate(outs[0][1]))
    suspect = cat([o[2] for o in outs])
    counters = None
    if guard:
        counters = {k: sum(o[3][k].to(home) for o in outs) for k in outs[0][3]}
    return cs, fms, suspect, counters
