"""The port's device mesh, placement, partition tables and collectives vs
the JAX package's ``parallel.mesh`` / ``parallel.partition``.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's counterpart is a mesh of repeated CPU devices
(``FMRP_VIRTUAL_DEVICES`` or an explicit device list). Compared:

- ``place_global``: every block of a NaN-carrying float array, a bool
  array and a replicated array equals the JAX shard at the same index
  (``tests/test_place_global.py``); ``pad_to_multiple`` and
  ``shard_panel`` pad and place as in ``tests/test_parallel.py``;
- the policies: ``MESH_DEVICES`` (1 → None, 0 → all, N → exactly N, more
  than there are raises) through ``default_mesh`` and ``pipeline_mesh``;
- the partition tables: the same spec for every leaf name in both packages
  (nested paths, NamedTuples, scalars), the same refusal of an unmatched
  leaf;
- the collectives (no JAX counterpart: the reference's tests read compiled
  HLO where these read ``COLLECTIVES``): a ``psum`` is the sequential sum
  in axis order bit for bit, on every member; ``all_gather`` stacks in axis
  order; ``ppermute`` hands the first member zeros; groups of a 2-D mesh
  stay apart.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from fm_returnprediction_tpu.parallel import make_mesh as jax_make_mesh
from fm_returnprediction_tpu.parallel import pad_to_multiple as jax_pad
from fm_returnprediction_tpu.parallel import place_global as jax_place_global
from fm_returnprediction_tpu.parallel import partition as jax_partition
from fm_returnprediction_tpu_torch.ops.ols import NormalStats
from fm_returnprediction_tpu_torch.parallel import mesh as M
from fm_returnprediction_tpu_torch.parallel import partition
from fm_returnprediction_tpu_torch.parallel.multihost import make_mesh_2d

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _port_mesh(n=4, axis="firms"):
    return M.make_mesh(axis_name=axis, devices=[CPU] * n)


def _jax_blocks(placed):
    return {tuple((s.start, s.stop) for s in shard.index): np.asarray(shard.data)
            for shard in placed.addressable_shards}


def _port_blocks(placed):
    return {tuple((s.start, s.stop) for s in placed.sharding.block(pos, placed.shape)):
            shard.numpy() for pos, shard in zip(placed.positions, placed.shards)}


@pytest.mark.parametrize("kind", ["nan_float", "bool", "replicated"])
def test_place_global_blocks_match_the_reference(kind):
    jmesh = jax_make_mesh(n_devices=4, axis_name="firms")
    pmesh = _port_mesh()
    if kind == "nan_float":
        a = np.arange(32.0, dtype=np.float32).reshape(4, 8)
        a[0, 0] = np.nan
        spec = (None, "firms")
    elif kind == "bool":
        a = np.arange(24).reshape(3, 8) % 3 == 0
        spec = (None, "firms")
    else:
        a = np.linspace(0, 1, 16)
        spec = ()
    want = _jax_blocks(jax_place_global(a, JaxNamedSharding(jmesh, JaxP(*spec))))
    placed = M.place_global(a, M.NamedSharding(pmesh, M.P(*spec)))
    got = _port_blocks(placed)
    assert placed.sharding.spec == M.P(*spec) and placed.dtype == torch.from_numpy(a).dtype
    norm = (lambda key: tuple((s or 0, e) for s, e in key))
    assert {norm(k) for k in got} == {norm(k) for k in want}
    for key, block in got.items():
        np.testing.assert_array_equal(block, want[next(k for k in want if norm(k) == norm(key))])
    np.testing.assert_array_equal(placed.numpy(), a)


def test_pad_and_shard_panel_match_the_reference():
    a = np.ones((5, 13, 3))
    np.testing.assert_array_equal(M.pad_to_multiple(torch.from_numpy(a), 1, 8).numpy(),
                                  np.asarray(jax_pad(a, axis=1, multiple=8)))
    assert M.pad_to_multiple(a, 0, 5).shape == (5, 13, 3)
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.standard_normal((6, 13)))
    x = torch.from_numpy(rng.standard_normal((6, 13, 2)))
    mask = torch.ones((6, 13), dtype=torch.bool)
    ys, xs, ms = M.shard_panel(y, x, mask, _port_mesh(8))
    assert ys.shape == (6, 16) and xs.shape == (6, 16, 2) and ms.shape == (6, 16)
    assert ys.sharding.spec[1] == "firms" and xs.sharding.spec[1] == "firms"
    assert [s.shape for s in xs.shards] == [(6, 2, 2)] * 8
    assert not ms.to_global()[:, 13:].any() and ys.to_global()[:, 13:].isnan().all()


def test_default_and_pipeline_mesh_honor_the_setting(monkeypatch):
    """``tests/test_parallel.py::test_default_mesh_honors_setting`` and
    ``tests/test_place_global.py::test_pipeline_mesh_policy``, with
    ``MESH_DEVICES`` read from the environment and 8 virtual devices."""
    monkeypatch.setenv("FMRP_VIRTUAL_DEVICES", "8")
    assert len(M.local_devices("cpu")) == len(jax.devices()) == 8
    monkeypatch.setenv("MESH_DEVICES", "0")
    assert M.default_mesh(device="cpu").size == 8
    monkeypatch.setenv("MESH_DEVICES", "4")
    assert M.default_mesh(device="cpu").size == 4
    monkeypatch.setenv("MESH_DEVICES", "1")
    assert M.default_mesh(device="cpu") is None and M.pipeline_mesh(device="cpu") is None
    monkeypatch.setenv("MESH_DEVICES", "8")
    mesh = M.pipeline_mesh(device="cpu")
    assert mesh.size == 8 and mesh.axis_names == ("firms",)
    monkeypatch.setenv("MESH_DEVICES", "9")
    with pytest.raises(ValueError, match="Requested 9 devices but only 8"):
        M.default_mesh(device="cpu")
    monkeypatch.delenv("FMRP_VIRTUAL_DEVICES")
    monkeypatch.delenv("MESH_DEVICES")
    assert M.local_devices("cpu") == [CPU] and M.default_mesh(device="cpu") is None


_TREE_NAMES = ("y", "mask", "row_weights", "x", "universes", "uidx", "col_sel", "window",
               "sel_aug", "center", "gram", "moment", "n", "ysum", "yy")


@pytest.mark.parametrize("table", ["panel", "stats"])
def test_partition_tables_give_the_reference_specs(table):
    port_rules = getattr(partition, f"specgrid_{table}_rules")("cells")
    jax_rules = getattr(jax_partition, f"specgrid_{table}_rules")("cells")
    for name in _TREE_NAMES:
        for prefix in ("", "panel/", "a/b/"):
            tree = {prefix + name: np.zeros((2, 3))} if not prefix else \
                {prefix.rstrip("/").split("/")[0]: _nest(prefix, name)}
            try:
                want = jax_partition.match_partition_rules(jax_rules, tree)
            except ValueError as exc:
                with pytest.raises(ValueError, match="partition rule not found"):
                    partition.match_partition_rules(port_rules, tree)
                assert "partition rule not found" in str(exc)
                continue
            got = partition.match_partition_rules(port_rules, tree)
            assert _specs(got) == _specs(want), (table, prefix, name)
    scalar = {"gram": np.float64(1.0), "x": np.zeros((1, 1, 1))}
    assert _specs(partition.match_partition_rules(port_rules, scalar)) == [(), ()]


def _nest(prefix: str, name: str):
    parts = prefix.rstrip("/").split("/")[1:] + [name]
    node = np.zeros((2, 3))
    for part in reversed(parts):
        node = {part: node}
    return node


def _specs(tree):
    return [tuple(spec) for _, spec in _walk(tree)]


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_tree_paths_and_shardings_match_the_reference():
    stats = NormalStats(*(np.zeros((3, 2)) for _ in range(5)))
    tree = {"panel": {"x": np.zeros((2, 4, 3)), "y": np.zeros((2, 4))}, "list": [np.zeros(2)],
            "stats": stats}
    got = [p for p, _ in partition.named_tree_paths(tree)]
    want = [p for p, _ in jax_partition.named_tree_paths(tree)]
    assert got == want
    rules = partition.specgrid_panel_rules() + ((r"^list/0$", M.P()),
                                                (r"^stats/", M.P("cells")))
    sh = partition.tree_shardings(_port_mesh(2, "cells"), rules, tree)
    assert sh["panel"]["x"].spec == M.P(None, "cells", None)
    assert isinstance(sh["stats"], NormalStats) and sh["stats"].gram.spec == M.P("cells")
    with pytest.raises(ValueError, match="partition rule not found"):
        partition.match_partition_rules(partition.SPECGRID_PANEL_RULES, {"mystery": np.zeros(9)})


def test_collectives_are_ordered_and_counted():
    mesh = _port_mesh(4, "firms")
    rng = np.random.default_rng(9)
    parts = [torch.from_numpy(rng.standard_normal(5) * 10.0 ** rng.integers(-8, 8, 5))
             for _ in range(4)]
    before = M.collective_counts()
    summed = M.psum(mesh, parts, "firms")
    seq = parts[0] + parts[1] + parts[2] + parts[3]
    assert all(torch.equal(s, seq) for s in summed)
    stats = M.psum(mesh, [NormalStats(p, p, p, p, p) for p in parts], "firms")
    assert isinstance(stats[2], NormalStats) and torch.equal(stats[2].yy, seq)
    gathered = M.all_gather(mesh, parts, "firms")
    assert all(torch.equal(g, torch.stack(parts)) for g in gathered)
    moved = M.ppermute(mesh, parts, "firms", [(i, i + 1) for i in range(3)])
    assert torch.equal(moved[0], torch.zeros(5, dtype=torch.float64))
    assert all(torch.equal(moved[i], parts[i - 1]) for i in range(1, 4))
    assert M.axis_index(mesh, "firms") == [0, 1, 2, 3]
    after = M.collective_counts()
    assert {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)} == {
        ("psum", "firms"): 2, ("all_gather", "firms"): 1, ("ppermute", "firms"): 1}

    grid = make_mesh_2d(month_shards=2, devices=[CPU] * 4)
    assert grid.shape == {"months": 2, "firms": 2}
    vals = [torch.tensor([float(i)]) for i in range(4)]
    assert [float(v) for v in M.psum(grid, vals, "firms")] == [1.0, 1.0, 5.0, 5.0]
    assert [float(v) for v in M.psum(grid, vals, "months")] == [2.0, 4.0, 2.0, 4.0]
    with pytest.raises(ValueError, match="Requested 5 devices but only 4"):
        M.make_mesh(5, devices=[CPU] * 4)
