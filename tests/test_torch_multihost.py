"""The port's months × firms hierarchy vs the JAX package
(``tests/test_multihost.py``).

The port's meshes are repeated CPU devices; the JAX side runs on the 8
virtual CPU devices of ``tests/conftest.py``. Pins are the reference's:
slopes, R² and coef at rtol 1e-6 / atol 1e-9, t-stats 1e-5, month validity
exact, month padding trimmed; Table 2 on the hierarchy equals the
one-device table frame for frame, the panel build 1e-12; the bootstrap
over the flattened hierarchy equals a 1-D mesh's at 1e-7. Where the
reference inspects the compiled program, the port reads ``COLLECTIVES``:
the hierarchy's only month-axis collective is one ``all_gather``.

One case runs across two spawned processes (gloo on the CPU, 2 virtual
devices each, a (2, 2) mesh with one row per process) and holds both
ranks against JAX's one-process ``fama_macbeth_hier`` on a (2, 2) mesh.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.ops.fama_macbeth import fama_macbeth as jax_fama_macbeth
from fm_returnprediction_tpu.panel.dense import long_to_dense
from fm_returnprediction_tpu.parallel import fama_macbeth_hier as jax_fm_hier
from fm_returnprediction_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from fm_returnprediction_tpu_torch.parallel import (
    as_flat_mesh,
    block_bootstrap_se,
    fama_macbeth_hier,
    initialize_multihost,
    make_mesh,
    make_mesh_2d,
)
from fm_returnprediction_tpu_torch.parallel import mesh as M

from oracle import make_synthetic_long_panel

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def _grid(month_shards, n=8):
    return make_mesh_2d(month_shards=month_shards, devices=[CPU] * n)


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(47)
    df, pred_cols = make_synthetic_long_panel(rng)
    dense = long_to_dense(df, "mthcaldt", "permno", ["retx"] + pred_cols)
    return tuple(np.asarray(a) for a in (dense.var("retx"), dense.select(pred_cols),
                                         dense.mask))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jax_fm(y, x, mask):
    return jax_fama_macbeth(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_initialize_multihost_single_process_noop(monkeypatch):
    monkeypatch.delenv("FMRP_MULTIHOST", raising=False)
    assert initialize_multihost() == (0, 1)


def test_initialize_multihost_from_the_environment(monkeypatch):
    """``FMRP_MULTIHOST=1`` reads ``FMRP_DIST_*`` (a world of one here, gloo
    on the CPU, the store on the coordinator's port + 1); without them it
    raises, naming them."""
    from fm_returnprediction_tpu_torch.parallel import multihost
    from fm_returnprediction_tpu_torch.parallel.distributed import free_port

    monkeypatch.setenv("FMRP_MULTIHOST", "1")
    for key in ("FMRP_DIST_COORDINATOR", "FMRP_DIST_PROCS", "FMRP_DIST_PROC_ID"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="FMRP_DIST_COORDINATOR"):
        initialize_multihost()
    monkeypatch.setenv("FMRP_DIST_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("FMRP_DIST_PROCS", "1")
    monkeypatch.setenv("FMRP_DIST_PROC_ID", "0")
    try:
        assert initialize_multihost() == (0, 1)
        assert multihost.distributed_client_active()
        assert torch.distributed.get_backend() == "gloo"
        assert make_mesh_2d(device="cpu").processes.tolist() == [[0]]
    finally:
        torch.distributed.destroy_process_group()


def test_make_mesh_2d_shapes_and_validation():
    mesh = _grid(2)
    assert mesh.shape == {"months": 2, "firms": 4} and mesh.devices.shape == (2, 4)
    with pytest.raises(ValueError, match="do not factor"):
        _grid(3)
    with pytest.raises(ValueError, match="month_shards"):
        _grid(0)
    flat = as_flat_mesh(mesh)
    assert flat.shape == {"boot": 8} and list(flat.devices) == list(mesh.devices.flat)


@pytest.mark.parametrize("month_shards", [2, 4])
def test_hier_fm_matches_single_chip(panel, month_shards):
    y, x, mask = panel
    cs_h, fm_h = fama_macbeth_hier(*_t(y, x, mask), mesh=_grid(month_shards))
    cs_1, fm_1 = _jax_fm(y, x, mask)
    assert tuple(cs_h.slopes.shape) == tuple(cs_1.slopes.shape)
    np.testing.assert_array_equal(cs_h.month_valid.numpy(), np.asarray(cs_1.month_valid))
    valid = np.asarray(cs_1.month_valid)
    tol = dict(rtol=1e-6, atol=1e-9)
    _close(cs_h.slopes.numpy()[valid], np.asarray(cs_1.slopes)[valid], **tol)
    _close(cs_h.r2.numpy()[valid], np.asarray(cs_1.r2)[valid], **tol)
    _close(fm_h.coef, fm_1.coef, **tol)
    _close(fm_h.tstat, fm_1.tstat, rtol=1e-5, atol=1e-8)


def test_hier_fm_gram_fast_path_and_default_mesh(panel, monkeypatch):
    """``n_refine=0`` inside the 2-D mesh, and ``mesh=None`` (a (1, D)
    hierarchy of this process's devices), both against one device."""
    y, x, mask = panel
    _, fm_1 = _jax_fm(y, x, mask)
    _, fm_g = fama_macbeth_hier(*_t(y, x, mask), mesh=_grid(2), n_refine=0)
    _close(fm_g.coef, fm_1.coef, rtol=1e-6, atol=1e-9)
    monkeypatch.setenv("FMRP_VIRTUAL_DEVICES", "8")
    _, fm_d = fama_macbeth_hier(*_t(y, x, mask))
    _close(fm_d.coef, fm_1.coef, rtol=1e-6, atol=1e-9)


def test_hier_fm_month_padding(panel):
    y, x, mask = panel
    t = y.shape[0] - 1 if (y.shape[0] - 1) % 4 else y.shape[0] - 3
    assert t % 4 != 0
    y, x, mask = y[:t], x[:t], mask[:t]
    cs_h, fm_h = fama_macbeth_hier(*_t(y, x, mask), mesh=_grid(4))
    cs_1, fm_1 = _jax_fm(y, x, mask)
    assert cs_h.slopes.shape[0] == t
    np.testing.assert_array_equal(cs_h.month_valid.numpy(), np.asarray(cs_1.month_valid))
    _close(fm_h.coef, fm_1.coef, rtol=1e-6, atol=1e-9)
    _close(fm_h.nw_se, fm_1.nw_se, rtol=1e-6, atol=1e-9)
    assert int(fm_h.n_months) == int(fm_1.n_months)


def test_hier_fm_near_singular_months():
    """Boundary months (n = P + 1, cond ~ 1e6) through the hierarchy. Their
    slopes reach ~9e6, so the reference's absolute 1e-6 pin is a bit-level
    one that holds for its own identical op sequence; the port's one-device
    QR solve already sits 1.6e-8 of scale from JAX's on this fixture. The
    hierarchy is held at the reference's near-singular pin of
    ``tests/test_parallel.py``: 1e-7 of ``max(|b|, 1)``, against JAX's
    one-device solve and the port's own."""
    from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth

    rng = np.random.default_rng(3)
    t, n, p = 12, 64, 5
    x = rng.standard_normal((t, n, p))
    y = rng.standard_normal((t, n))
    mask = np.ones((t, n), bool)
    for ti in range(0, t, 2):
        mask[ti, p + 1:] = False
        base = rng.standard_normal(p)
        for r in range(p + 1):
            x[ti, r] = base + 1e-6 * rng.standard_normal(p)
    y = np.where(mask, y, np.nan)
    cs_h, _ = fama_macbeth_hier(*_t(y, x, mask), mesh=_grid(2))
    cs_1, _ = _jax_fm(y, x, mask)
    cs_p, _ = fama_macbeth(*_t(y, x, mask))
    assert np.asarray(cs_1.month_valid).all() and cs_h.month_valid.all()
    for want in (np.asarray(cs_1.slopes), cs_p.slopes.numpy()):
        drift = np.max(np.abs(cs_h.slopes.numpy() - want) / np.maximum(np.abs(want), 1.0))
        assert drift < 1e-7, drift


def test_hier_fm_collective_contract(panel):
    """The reference asserts on the compiled program that the months carry
    one small reduction and nothing else; here: firm-axis sums and one
    firm-axis TSQR gather, one month-axis gather, no permute."""
    y, x, mask = panel
    before = M.collective_counts()
    fama_macbeth_hier(*_t(y, x, mask), mesh=_grid(2))
    after = M.collective_counts()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert delta == {("psum", "firms"): 2, ("all_gather", "firms"): 1,
                     ("all_gather", "months"): 1}


@pytest.fixture(scope="module")
def synthetic_frames():
    from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds

    return generate_synthetic_wrds(SyntheticConfig(n_firms=60, n_months=60))


def test_table2_and_panel_on_hier_mesh_match_single_device(synthetic_frames):
    """``test_table2_on_hier_mesh_matches_single_device`` and
    ``test_build_panel_on_hier_mesh_matches_single_device`` in one build:
    the port's panel from the same frames with and without the hierarchy,
    then Table 2 on each mesh against one device and against JAX's table
    on its (2, 4) hierarchy."""
    from fm_returnprediction_tpu.panel.subsets import compute_subset_masks as jax_masks
    from fm_returnprediction_tpu.pipeline import build_panel as jax_build_panel
    from fm_returnprediction_tpu.reporting.table2 import build_table_2 as jax_build_table_2
    from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
    from fm_returnprediction_tpu_torch.pipeline import build_panel
    from fm_returnprediction_tpu_torch.reporting.table2 import build_table_2

    kw = dict(dtype=torch.float64, device="cpu")
    one, factors = build_panel(synthetic_frames, **kw)
    hier, _ = build_panel(synthetic_frames, mesh=_grid(2), **kw)
    np.testing.assert_allclose(hier.values.numpy(), one.values.numpy(), rtol=1e-12, atol=1e-12,
                               equal_nan=True)
    masks = compute_subset_masks(one)
    want = build_table_2(one, masks, factors)
    pd.testing.assert_frame_equal(build_table_2(one, masks, factors, mesh=_grid(2)), want)
    jp, jfactors = jax_build_panel(synthetic_frames, dtype=np.float64)
    jt = jax_build_table_2(jp, jax_masks(jp), jfactors, mesh=jax_make_mesh_2d(month_shards=2))
    a, b = want.to_numpy().astype(str).ravel(), jt.to_numpy().astype(str).ravel()
    assert want.shape == jt.shape and (a == b).mean() > 0.95


def test_bootstrap_on_flattened_hier_mesh(panel):
    y, x, mask = panel
    cs, _ = _jax_fm(y, x, mask)
    slopes = torch.from_numpy(np.array(cs.slopes))
    valid = torch.from_numpy(np.array(cs.month_valid))[:, None] & torch.isfinite(slopes)
    flat = block_bootstrap_se(slopes, valid, seed=11, n_replicates=64,
                              mesh=as_flat_mesh(_grid(2)))
    one_d = block_bootstrap_se(slopes, valid, seed=11, n_replicates=64,
                               mesh=make_mesh(axis_name="boot", devices=[CPU] * 8))
    _close(flat.se, one_d.se, rtol=1e-7, atol=1e-12)


@pytest.mark.timeout(120)
def test_hier_fm_across_two_processes_matches_the_reference(panel, tmp_path):
    """Two spawned ranks (gloo, 2 virtual CPU devices each) form a (2, 2)
    hierarchy, one mesh row per process: the firm-axis collectives stay in
    a process and the month gather crosses by ``torch.distributed``. Both
    ranks' results equal JAX's one-process hierarchy on a (2, 2) mesh at
    the reference's pins, and each other bit for bit."""
    from fm_returnprediction_tpu_torch.parallel.distributed import free_port

    y, x, mask = panel
    np.savez(tmp_path / "panel.npz", y=y, x=x, mask=mask)
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "FMRP_VIRTUAL_DEVICES": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", HIER_RANK, str(rank), str(port),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(2)]
    deadline = time.monotonic() + 110
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n---\n".join(outs)
    jmesh = jax_make_mesh_2d(month_shards=2, devices=jax.devices()[:4])
    cs_j, fm_j = jax_fm_hier(jnp.asarray(y), jnp.asarray(x), jnp.asarray(mask), mesh=jmesh)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for g in got:
        assert g["mesh_processes"].tolist() == [[0, 0], [1, 1]]
        assert g["collectives"].tolist() == [2, 1, 1]
        valid = np.asarray(cs_j.month_valid)
        np.testing.assert_array_equal(g["month_valid"], valid)
        _close(g["slopes"][valid], np.asarray(cs_j.slopes)[valid], rtol=1e-6, atol=1e-9)
        _close(g["coef"], fm_j.coef, rtol=1e-6, atol=1e-9)
        _close(g["tstat"], fm_j.tstat, rtol=1e-5, atol=1e-8)
    for k in ("slopes", "coef", "tstat"):
        np.testing.assert_array_equal(got[0][k], got[1][k])


# the rank's program: a fresh interpreter that imports the port only
HIER_RANK = """
import sys
from pathlib import Path

import numpy as np
import torch

from fm_returnprediction_tpu_torch.parallel import fama_macbeth_hier, initialize_multihost
from fm_returnprediction_tpu_torch.parallel import make_mesh_2d
from fm_returnprediction_tpu_torch.parallel import mesh as M

rank, port, out = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
assert initialize_multihost(f"127.0.0.1:{port}", 2, rank) == (rank, 2)
assert torch.distributed.get_backend() == "gloo"
data = np.load(out / "panel.npz")
mesh = make_mesh_2d(device="cpu")
cs, fm = fama_macbeth_hier(*(torch.from_numpy(data[k]) for k in ("y", "x", "mask")), mesh=mesh)
counts = M.collective_counts()
np.savez(out / f"rank{rank}.npz", slopes=cs.slopes.numpy(), month_valid=cs.month_valid.numpy(),
         coef=fm.coef.numpy(), tstat=fm.tstat.numpy(), mesh_processes=mesh.processes,
         collectives=np.array([counts[("psum", "firms")], counts[("all_gather", "firms")],
                               counts[("all_gather", "months")]]))
blocked = [m for m in sys.modules if m == "jax" or m.startswith("fm_returnprediction_tpu.")]
assert not blocked, blocked
torch.distributed.destroy_process_group()
"""
