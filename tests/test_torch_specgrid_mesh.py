"""The port's spec grid on a device mesh vs the JAX package's one-device
grid (the mesh cases of ``tests/test_specgrid_scale.py``).

The port's mesh is 8 repeated CPU devices (4 for the sweep); the JAX side
is its one-device grid route at float64. Pins are the reference's mesh
differential, rtol 1e-6 / atol 1e-6 with the NaN pattern, month validity
and month counts exact:

- ``run_spec_grid(mesh=)`` with 7 specs over 8 shards (ghost specs pad the
  spec axis), one contraction per shard against the shared global center;
- the tile engine's sweep on a mesh, frame for frame; the placed panel is
  kept only for one sweep and re-placed after an in-place update;
- ``FMRP_SPECGRID_MESH``: unset/0/1 → None, N → exactly N, ``auto`` → every
  local device, an explicit mesh wins; and the refusals the reference makes
  (a mesh with processes, with bf16, with ``factorize="on"``, and the
  estimator kinds beyond OLS on a mesh).
"""

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.specgrid import Spec as JaxSpec
from fm_returnprediction_tpu.specgrid import SpecGrid as JaxSpecGrid
from fm_returnprediction_tpu.specgrid import run_spec_grid as jax_run_spec_grid
from fm_returnprediction_tpu.specgrid.cellspace import CellSpace as JaxCellSpace
from fm_returnprediction_tpu.specgrid.engine import run_cellspace as jax_run_cellspace
from fm_returnprediction_tpu_torch.parallel import mesh as M
from fm_returnprediction_tpu_torch.specgrid import (
    Spec,
    SpecGrid,
    resolve_specgrid_mesh,
    run_cellspace,
    run_spec_grid,
    sharded,
    specgrid_mesh,
)
from fm_returnprediction_tpu_torch.specgrid.cellspace import CellSpace
from fm_returnprediction_tpu_torch.specgrid.estimators import parse_estimator

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
FIELDS = ("coef", "tstat", "nw_se", "mean_r2", "mean_n", "slopes", "intercept", "r2", "n_obs")


def _mesh(n=8):
    return M.make_mesh(axis_name="cells", devices=[CPU] * n)


def _panel(rng, t=36, n=120, p=6, nan_frac=0.05):
    x = rng.standard_normal((t, n, p))
    beta = rng.standard_normal(p) * 0.1
    y = x @ beta + 0.2 * rng.standard_normal((t, n))
    mask = rng.random((t, n)) > 0.2
    y = np.where(mask, y, np.nan)
    x[rng.random((t, n, p)) < nan_frac] = np.nan
    size = rng.random(n)
    return y, x, {"All": mask, "Big": mask & (size > 0.4)[None, :]}


def _space(cls, p=6):
    names = tuple(f"x{i}" for i in range(p))
    return cls(regressor_sets=(("m2", names[:2]), ("m4", names[:4]), ("m6", names)),
               universes=("All", "Big"), windows=(("full", None), ("late", (18, 36))))


def _torch(y, x, masks):
    return (torch.from_numpy(y), torch.from_numpy(x),
            {k: torch.from_numpy(m) for k, m in masks.items()})


def _close(a, b, what):
    a, b = np.asarray(a, float), np.asarray(b, float)
    both = np.isnan(a) & np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_allclose(np.where(both, 0.0, a), np.where(both, 0.0, b), rtol=1e-6,
                               atol=1e-6, err_msg=what)


def test_sharded_solve_matches_single_device(monkeypatch):
    rng = np.random.default_rng(37)
    y, x, masks = _panel(rng, t=30, n=96, p=5)
    names = [f"x{i}" for i in range(5)]

    def grid(spec_cls, grid_cls):
        return grid_cls(tuple(spec_cls(f"m{k} | {u}", tuple(names[:k]), u)
                              for k in (2, 5) for u in masks)
                        + (spec_cls("late | All", tuple(names[:3]), "All", window=(10, 30)),))

    want = jax_run_spec_grid(y, x, masks, grid(JaxSpec, JaxSpecGrid))
    calls = []
    real = sharded.contract_spec_grams
    monkeypatch.setattr(sharded, "contract_spec_grams",
                        lambda *a, **k: calls.append(k["center"]) or real(*a, **k))
    before = M.collective_counts()
    got = run_spec_grid(*_torch(y, x, masks), grid(Spec, SpecGrid), mesh=_mesh())
    assert len(calls) == 8 and all(torch.equal(c, calls[0]) for c in calls)
    after = M.collective_counts()
    assert after[("psum", "cells")] - before.get(("psum", "cells"), 0) == 3
    one = run_spec_grid(*_torch(y, x, masks), grid(Spec, SpecGrid))
    for field in FIELDS:
        _close(getattr(got, field), getattr(want, field), field)
        _close(getattr(got, field), getattr(one, field), field)
    for field in ("month_valid", "n_months"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_sharded_engine_sweep_matches_single_device_sweep():
    rng = np.random.default_rng(41)
    y, x, masks = _panel(rng, nan_frac=0.0)
    want, _ = jax_run_cellspace(y, x, masks, _space(JaxCellSpace), sink="frame",
                                mask=masks["All"])
    got, stats = run_cellspace(*_torch(y, x, masks), _space(CellSpace), sink="frame",
                               mask=masks["All"], mesh=_mesh(4))
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    assert stats["gram_factorize"] == "off"
    assert sharded._PLACED_PANEL_CACHE is None  # the sweep's placed panel went with it
    for col in ("coef", "tstat", "nw_se", "mean_r2"):
        _close(got[col].to_numpy(), want[col].to_numpy(), col)


def test_placed_panel_memo_is_scoped_and_follows_in_place_updates():
    """The placed panel is kept only inside ``placed_panel_scope`` (the
    engine's sweep), and an in-place update of a panel tensor re-places it."""
    rng = np.random.default_rng(43)
    y, x, masks = _torch(*_panel(rng, t=24, n=64, p=3, nan_frac=0.0))
    grid = SpecGrid((Spec("m", ("x0", "x1", "x2"), "All"),))
    mesh = _mesh(4)
    run_spec_grid(y, x, masks, grid, mesh=mesh)
    assert sharded._PLACED_PANEL_CACHE is None
    with sharded.placed_panel_scope():
        first = run_spec_grid(y, x, masks, grid, mesh=mesh)
        assert sharded._PLACED_PANEL_CACHE is not None
        x.mul_(2.0)
        got = run_spec_grid(y, x, masks, grid, mesh=mesh)
    assert sharded._PLACED_PANEL_CACHE is None
    want = run_spec_grid(y, x, masks, grid)
    _close(got.coef, want.coef, "coef after an in-place update")
    _close(got.coef, np.asarray(first.coef) / 2.0, "slopes of a doubled design")


def test_resolve_specgrid_mesh_env_and_refusals(monkeypatch):
    monkeypatch.delenv("FMRP_SPECGRID_MESH", raising=False)
    assert resolve_specgrid_mesh(None, device="cpu") is None
    for value in ("0", "1"):
        monkeypatch.setenv("FMRP_SPECGRID_MESH", value)
        assert resolve_specgrid_mesh(None, device="cpu") is None
    monkeypatch.setenv("FMRP_VIRTUAL_DEVICES", "8")
    monkeypatch.setenv("FMRP_SPECGRID_MESH", "2")
    mesh = resolve_specgrid_mesh(None, device="cpu")
    assert mesh.size == 2 and mesh.axis_names == ("cells",)
    monkeypatch.setenv("FMRP_SPECGRID_MESH", "auto")
    assert resolve_specgrid_mesh(None, device="cpu").size == 8
    monkeypatch.setenv("FMRP_SPECGRID_MESH", "16")
    with pytest.raises(ValueError, match="Requested 16 devices"):
        resolve_specgrid_mesh(None, device="cpu")
    explicit = specgrid_mesh(1, device="cpu")
    assert resolve_specgrid_mesh(explicit) is explicit
    monkeypatch.delenv("FMRP_SPECGRID_MESH")

    rng = np.random.default_rng(5)
    y, x, masks = _torch(*_panel(rng, t=12, n=16, p=2))
    grid = SpecGrid((Spec("m", ("x0", "x1"), "All"),))
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_spec_grid(y, x, masks, grid, mesh=_mesh(2), procs=2)
    with pytest.raises(ValueError, match="bf16"):
        run_spec_grid(y, x, masks, grid, mesh=_mesh(2), precision="bf16")
    with pytest.raises(ValueError, match="single-device"):
        run_spec_grid(y, x, masks, grid, mesh=_mesh(2), factorize="on")
    space = CellSpace(regressor_sets=(("m", ("x0", "x1")),), universes=("All",),
                      windows=(("full", None),), estimators=(parse_estimator("fwl:x1"),))
    with pytest.raises(ValueError, match="single-device"):
        run_cellspace(y, x, masks, space, mesh=_mesh(2), mask=masks["All"])
