"""The port's multi-process paths on the CPU, held to
``tests/test_multiprocess.py``'s contracts (the cases of ROADMAP A8a):
spawned Python processes, every one of them importing the port only.

- **The host exchange.** allgather / ``sum_tree`` / broadcast / barrier
  and the telemetry identity across 3 spawned processes; a barrier tag
  skew raises; the port's frames and the reference's are the same bytes,
  so a port rank and a JAX-package rank share one exchange.
- **The grid across processes.** ``run_spec_grid(procs=2|3)`` on the
  port equals the JAX package's single-process contraction and grid on
  the same seeded numpy panel (rtol 1e-13 f64; the float32 stats at 1e-6,
  the float32 solved grid as the test says), over both transports; the workers report their device, their K2
  launches and their builds (at most one build over the pool); a killed
  worker gives the disclosed ``degraded_ranks`` (the exact partial sum
  over the survivor), or ``DegradedWorldError`` under
  ``FMRP_TOPO_DEGRADED_GRID=0``; the knob combinations the reference
  refuses raise (``tests/test_grid_factorize.py``'s procs case).
- **Process replicas.** A SIGKILLed replica process whose in-flight
  requests requeue and whose journal replays clean; warm-pool spawns
  (``WarmReport`` in the hello, 0 builds) and a two-phase rollover over
  the wire.

Each spawned process gets its own time budget; the file runs in about a
minute here.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.torch_port, pytest.mark.multiprocess]

REPO = Path(__file__).resolve().parent.parent
PORT_ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def _spawn_ranks(mode: str, nprocs: int, budget_s: float = 90.0):
    """Spawn ``nprocs`` copies of this file's ``__main__`` helper and
    gather their outputs within one shared budget."""
    from fm_returnprediction_tpu_torch.parallel.distributed import free_port

    port = free_port()
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(i), str(nprocs), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=PORT_ENV)
             for i in range(nprocs)]
    outs = []
    deadline = time.monotonic() + budget_s
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail("exchange workers hung:\n" + "\n---\n".join(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


# -- the host exchange --------------------------------------------------------


def test_three_process_host_exchange_collectives():
    """allgather / sum_tree / broadcast / barrier across 3 spawned
    processes, plus the process_index identity the bootstrap stamps."""
    procs, outs = _spawn_ranks("exchange", 3)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} rc={p.returncode}:\n{out}"
        assert f"EX_OK {i}" in out, out


def test_barrier_tag_skew_raises():
    """Program-order divergence is a raise, not a hang."""
    from fm_returnprediction_tpu_torch.parallel.distributed import (
        DistConfig,
        DistributedError,
        HostExchange,
        free_port,
    )

    port = free_port()
    errs = {}

    def rank(r, tag):
        ex = HostExchange(DistConfig(f"127.0.0.1:{port}", 2, r), timeout_s=30.0)
        try:
            ex.barrier(tag)
        except DistributedError as exc:
            errs[r] = str(exc)
        finally:
            ex.close()

    t1 = threading.Thread(target=rank, args=(1, "phase_B"))
    t1.start()
    rank(0, "phase_A")
    t1.join(timeout=30)
    assert "tag skew" in errs[0] and "tag skew" in errs[1]


def test_dist_jax_knob_brings_up_torch_distributed(monkeypatch):
    """``FMRP_DIST_JAX`` asks for device collectives across processes, the
    device mesh's transport: ``1`` brings up ``torch.distributed`` beside
    the host exchange (here a world of one, gloo on the CPU, its store on
    the coordinator's port + 1), ``auto`` only where a CUDA device is, ``0``
    never; any other value raises before a socket is opened."""
    from fm_returnprediction_tpu_torch.parallel import distributed as dist
    from fm_returnprediction_tpu_torch.parallel import multihost

    cfg = dist.DistConfig.from_env({"FMRP_DIST_COORDINATOR": "127.0.0.1:1",
                                    "FMRP_DIST_PROCS": "2", "FMRP_DIST_PROC_ID": "1",
                                    "FMRP_DIST_JAX": "1"})
    assert (cfg.host, cfg.port, cfg.num_processes, cfg.process_id) == ("127.0.0.1", 1, 2, 1)
    with pytest.raises(ValueError, match="FMRP_DIST_JAX"):
        dist.initialize_distributed(dataclasses.replace(cfg, jax_collectives="sometimes"))
    assert not dist.dist_active() and dist.process_index() == 0
    assert dist._want_collectives(cfg)
    assert not dist._want_collectives(dataclasses.replace(cfg, jax_collectives="0"))
    assert dist._want_collectives(dataclasses.replace(cfg, jax_collectives="auto")) == \
        torch.cuda.is_available()
    port = next(p for p in iter(dist.free_port, None) if _port_free(p + 1))
    one = dataclasses.replace(cfg, coordinator=f"127.0.0.1:{port}", num_processes=1,
                              process_id=0)
    try:
        assert dist.initialize_distributed(one) == (0, 1)
        assert multihost.distributed_client_active()
        assert torch.distributed.get_backend() == "gloo"
        assert multihost.initialize_multihost() == (0, 1)     # idempotent
    finally:
        dist.shutdown_distributed()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert not multihost.distributed_client_active()


def _port_free(port: int) -> bool:
    import socket

    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def test_frames_interoperate_with_the_reference_exchange():
    """The wire format is the reference's byte for byte: a frame sent by
    one package reads in the other, and a JAX-package rank 0 and a port
    rank 1 form one exchange whose sum_tree both ranks agree on."""
    import socket

    from fm_returnprediction_tpu.parallel import distributed as jdist
    from fm_returnprediction_tpu_torch.parallel import distributed as pdist

    a, b = socket.socketpair()
    try:
        payload = b"\x00frame\xff" * 7
        assert jdist.send_frame(a, payload) == pdist.send_frame(a, payload)
        assert pdist.recv_frame(b) == payload and jdist.recv_frame(b) == payload
    finally:
        a.close()
        b.close()

    port = pdist.free_port()
    got = {}

    def port_rank():
        ex = pdist.HostExchange(pdist.DistConfig(f"127.0.0.1:{port}", 2, 1), timeout_s=30.0)
        try:
            got[1] = (ex.allgather_obj("port"),
                      ex.sum_tree({"g": np.full((2, 2), 2.0), "n": np.array([3])}))
        finally:
            ex.close()

    t = threading.Thread(target=port_rank)
    t.start()
    ex = jdist.HostExchange(jdist.DistConfig(f"127.0.0.1:{port}", 2, 0), timeout_s=30.0)
    try:
        got[0] = (ex.allgather_obj("jax"),
                  ex.sum_tree({"g": np.full((2, 2), 1.0), "n": np.array([4])}))
    finally:
        t.join(timeout=30)
        ex.close()
    for r in (0, 1):
        names, tree = got[r]
        assert names == ["jax", "port"]
        assert np.array_equal(tree["g"], np.full((2, 2), 3.0)) and tree["n"][0] == 7


# -- the spec grid across processes -------------------------------------------


def _mp_panel(rng, t=48, n=90, p=6, dtype=np.float64):
    x = rng.standard_normal((t, n, p)).astype(dtype)
    beta = rng.standard_normal(p) * 0.1
    y = (x @ beta + 0.2 * rng.standard_normal((t, n))).astype(dtype)
    mask = rng.random((t, n)) > 0.2
    y = np.where(mask, y, np.nan).astype(dtype)
    size = rng.random(n)
    masks = {"All": mask, "Big": mask & (size > 0.4)[None, :]}
    return y, x, masks


def _mp_grid(package):
    names = [f"x{i}" for i in range(6)]
    return package.SpecGrid(tuple(
        package.Spec(f"m{k} | {u}", tuple(names[:k]), u)
        for k in (3, 6) for u in ("All", "Big")))


_GRID_FIELDS = ("coef", "tstat", "nw_se", "slopes", "intercept", "mean_r2", "mean_n",
                "r2", "month_valid")


def _assert_grid_close(ref, got, rtol, atol):
    for field in _GRID_FIELDS:
        a = np.asarray(getattr(ref, field), float)
        b = np.asarray(getattr(got, field), float)
        both_nan = np.isnan(a) & np.isnan(b)
        np.testing.assert_allclose(np.where(both_nan, 0.0, a), np.where(both_nan, 0.0, b),
                                   rtol=rtol, atol=atol, err_msg=field)


@pytest.mark.parametrize("dtype,rtol,atol,procs,transport", [
    (np.float64, 1e-13, 1e-13, 2, "frames"),
    (np.float32, 1e-6, 1e-6, 2, "shm"),
    (np.float64, 1e-13, 1e-13, 3, "shm"),
    (np.float32, 1e-6, 1e-6, 3, "frames"),
])
def test_multiproc_specgrid_matches_single_process(dtype, rtol, atol, procs, transport,
                                                   monkeypatch):
    """``procs`` worker processes on the CPU + the host merge, on the same
    numpy panel (91 firms: padded to a multiple of 2 and of 3):

    - the merged Gram stats equal the JAX package's single-process
      ``contract_spec_grams`` at the reference's pins (1e-13 f64, 1e-6
      f32, of each leaf's largest entry);
    - the solved grid equals JAX's single-process ``run_spec_grid`` at the
      same pins in float64, every output field. In float32 the port solves
      in float32 where the reference solves in float64 (ROADMAP §C): the
      float32 eigensolve turns the merge's ~1e-7 summation-order change
      into up to ~4e-6 of a t-stat, so there the grid is held at rtol
      1e-5 against the port's own one-process grid and at the
      float32-solve pin (1e-4 of ``max(|v|, 1)``) against JAX's."""
    import jax.numpy as jnp

    from fm_returnprediction_tpu import specgrid as jspecgrid
    from fm_returnprediction_tpu.specgrid.grams import contract_spec_grams as jax_contract
    from fm_returnprediction_tpu_torch import specgrid as pspecgrid
    from fm_returnprediction_tpu_torch.specgrid import multiproc
    from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid

    monkeypatch.setenv("FMRP_GRID_TRANSPORT", transport)
    rng = np.random.default_rng(7)
    y, x, masks = _mp_panel(rng, n=91, dtype=dtype)
    jgrid, pgrid = _mp_grid(jspecgrid), _mp_grid(pspecgrid)
    names = list(masks)
    uni = np.stack([masks[nm] for nm in names])
    args = (uni, pgrid.universe_index(names), pgrid.column_selector(),
            pgrid.window_masks(y.shape[0]))
    want_stats = jax_contract(jnp.asarray(y), jnp.asarray(x), *map(jnp.asarray, args))
    ref = jspecgrid.run_spec_grid(y, x, masks, jgrid)
    tmasks = {k: torch.from_numpy(v) for k, v in masks.items()}
    try:
        got = run_spec_grid(torch.from_numpy(y), torch.from_numpy(x), tmasks, pgrid,
                            procs=procs)
        pool = multiproc.cached_pool()
        assert pool.procs == procs and pool.transport == transport
        assert len(pool.last_reports) == procs
        assert all(r["device"] == "cpu" and r["launches"] == 0 for r in pool.last_reports)
        got_stats = pool.contract(*args[1:])
    finally:
        multiproc._close_cached_pool()
    for g, w in zip(got_stats, want_stats):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())
    if dtype == np.float64:
        _assert_grid_close(ref, got, rtol, atol)
        return
    one = run_spec_grid(torch.from_numpy(y), torch.from_numpy(x), tmasks, pgrid)
    _assert_grid_close(one, got, 1e-5, 1e-5)
    for field in _GRID_FIELDS:
        a = np.asarray(getattr(ref, field), float)
        b = np.asarray(getattr(got, field), float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=field)
        fin = np.isfinite(a)
        assert np.all(np.abs(a[fin] - b[fin]) <= 1e-4 * np.fmax(np.abs(a[fin]), 1.0)), field


def _pool_inputs(seed=11, t=36, n=60, p=4):
    rng = np.random.default_rng(seed)
    y, x, masks = _mp_panel(rng, t=t, n=n, p=p)
    uni = np.stack([masks["All"]]).astype(bool)
    return y, x, uni, np.zeros(1, np.int64), np.ones((1, p), bool), np.ones((1, t), bool)


def test_multiproc_specgrid_at_most_one_build_over_the_pool(tmp_path):
    """With a registry armed the pool staggers the first contraction
    (worker 1 makes the kernel library loadable, a barrier, then the
    rest): every worker reports in the round reply, and the builds summed
    over the pool are at most one (none on the CPU, whose plain version
    needs no build); the exchange's byte and time accounting moved."""
    from fm_returnprediction_tpu_torch.specgrid import multiproc

    y, x, uni, uidx, col_sel, window = _pool_inputs()
    pool = multiproc.SpecGridWorkerPool(
        2, y, x, uni, child_env={"FMRP_REGISTRY_DIR": str(tmp_path / "registry")},
        device="cpu", transport="frames")
    try:
        pool.contract(uidx, col_sel, window, report=True)
        reports = {r["rank"]: r for r in pool.last_reports}
        assert set(reports) == {1, 2}, reports
        assert sum(r["nvcc_runs"] for r in reports.values()) <= 1
        assert all(r["device"] == "cpu" for r in reports.values())
        assert pool.worker_launches == 0
        assert pool.last_merge_bytes > 0 and pool.last_merge_s > 0
    finally:
        pool.close()


@pytest.mark.parametrize("allow", ["1", "0"])
def test_killed_worker_degrades_or_refuses(allow, monkeypatch):
    """Worker 2 SIGKILLed at ``grid.rank_death`` with its job received: by
    default the pool respawns the survivor as a smaller world and returns
    the exact stats of shard 1 alone, disclosed in ``degraded_ranks``;
    with ``FMRP_TOPO_DEGRADED_GRID=0`` it raises ``DegradedWorldError``
    naming the dead shard."""
    from fm_returnprediction_tpu_torch.resilience.errors import DegradedWorldError
    from fm_returnprediction_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from fm_returnprediction_tpu_torch.specgrid import multiproc
    from fm_returnprediction_tpu_torch.specgrid.grams import contract_spec_grams

    monkeypatch.setenv("FMRP_TOPO_DEGRADED_GRID", allow)
    y, x, uni, uidx, col_sel, window = _pool_inputs()
    with FaultPlan({"grid.rank_death": FaultSpec(times=1, sigkill=True, proc="2")}):
        pool = multiproc.SpecGridWorkerPool(2, y, x, uni, device="cpu", transport="frames")
    try:
        if allow == "0":
            with pytest.raises(DegradedWorldError) as exc:
                pool.contract(uidx, col_sel, window)
            assert exc.value.dead_ranks == (2,)
            return
        got = pool.contract(uidx, col_sel, window)
        assert pool.degraded_ranks == (2,)
        half = x.shape[1] // 2
        want = contract_spec_grams(
            torch.from_numpy(y[:, :half]), torch.from_numpy(x[:, :half]),
            torch.from_numpy(uni[:, :, :half]), torch.from_numpy(uidx),
            torch.from_numpy(col_sel), torch.from_numpy(window))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-12, atol=1e-12)
    finally:
        pool.close()


def test_multiproc_refuses_what_the_reference_refuses():
    """``tests/test_grid_factorize.py``'s procs case and its neighbours:
    ``factorize="on"``, bf16 operands and a mesh each refuse ``procs`` > 1
    before anything is spawned; a mesh without ``procs`` runs."""
    from fm_returnprediction_tpu_torch.specgrid import Spec, SpecGrid
    from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid

    names = ("c0",)
    grid = SpecGrid((Spec("m", names, "all"),), union=names)
    y = torch.zeros((3, 8), dtype=torch.float64)
    x = torch.zeros((3, 8, 1), dtype=torch.float64)
    masks = {"all": torch.ones((3, 8), dtype=torch.bool)}
    with pytest.raises(ValueError, match="single-device"):
        run_spec_grid(y, x, masks, grid, procs=2, factorize="on")
    with pytest.raises(ValueError, match="bf16"):
        run_spec_grid(y, x, masks, grid, procs=2, precision="bf16")
    from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid_weights

    with pytest.raises(ValueError, match="mutually exclusive"):
        run_spec_grid_weights(y, x, masks, grid, ("reference",), mesh=object(), procs=2)
    # the mesh itself runs (the sharded grid, ``tests/test_torch_specgrid_mesh.py``)
    # and gives the one-device grid on this panel
    from fm_returnprediction_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(axis_name="cells", devices=[torch.device("cpu")] * 2)
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((12, 8)))
    x = torch.from_numpy(rng.standard_normal((12, 8, 1)))
    masks = {"all": torch.ones((12, 8), dtype=torch.bool)}
    one = run_spec_grid_weights(y, x, masks, grid, ("reference",))["reference"]
    sharded = run_spec_grid_weights(y, x, masks, grid, ("reference",), mesh=mesh)["reference"]
    np.testing.assert_allclose(sharded.coef, one.coef, rtol=1e-10, atol=1e-13)
    np.testing.assert_array_equal(sharded.month_valid, one.month_valid)


# -- process replicas ----------------------------------------------------------


def _fleet_state(rng, t=48, n=120, p=4):
    from fm_returnprediction_tpu_torch.serving import build_serving_state

    x = rng.standard_normal((t, n, p)).astype(np.float32)
    beta = (rng.standard_normal(p) * 0.05).astype(np.float32)
    y = (x @ beta + 0.1 * rng.standard_normal((t, n))).astype(np.float32)
    mask = rng.random((t, n)) > 0.2
    y = np.where(mask, y, np.nan).astype(np.float32)
    state = build_serving_state(torch.from_numpy(y), torch.from_numpy(x),
                                torch.from_numpy(mask), window=24, min_periods=12)
    return state, y, x, mask


def test_process_fleet_sigkill_replica_journal_replays_clean(tmp_path):
    """Replicas are OS processes; one is SIGKILLed with requests in
    flight. The torn socket fails them with ReplicaDeadError, the router
    requeues them onto the survivor, the supervisor's stats heartbeat
    finds the corpse and replaces it with a new process, and the journal
    (written by the router) replays clean."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet, replay_journal

    rng = np.random.default_rng(0)
    state, _, _, _ = _fleet_state(rng)
    journal = tmp_path / "journal.jsonl"
    fleet = ServingFleet(state, 2, replica_mode="process", transport="socket",
                         journal=str(journal), max_batch=32, max_latency_ms=2.0, device="cpu")
    try:
        months = np.nonzero(state.have_coef())[0]
        xs = rng.standard_normal((40, state.n_predictors)).astype(np.float32)
        out = fleet.query_many([int(months[i % len(months)]) for i in range(40)], xs)
        assert np.isfinite(out).sum() == 40
        rid = sorted(fleet.replica_states())[0]
        rep = fleet.replica(rid)
        child_pid = rep.service.pid
        futs = [fleet.submit(int(months[0]), xs[0]) for _ in range(10)]
        rep.service.proc.send_signal(signal.SIGKILL)
        rep.service.proc.wait(timeout=30)
        deadline = time.monotonic() + 60
        while (fleet.replica_states().get(rid) not in (None, "dead")
               and time.monotonic() < deadline):
            fleet.supervisor.tick()
            time.sleep(0.05)
        fleet.supervisor.tick()  # DEAD → failover replacement
        res = np.asarray([f.result(timeout=60) for f in futs])
        assert np.isfinite(res).all(), "in-flight requests must survive"
        stats = fleet.stats()
        assert stats["requeues_total"] >= 1 or stats["failovers_total"] >= 1
        assert stats["healthy_replicas"] >= 2
        new_rids = set(fleet.replica_states()) - {rid}
        assert all(fleet.replica(r).service.pid != child_pid for r in new_rids)
    finally:
        fleet.close()
    replay = replay_journal(journal)
    assert replay.clean, (replay.dropped, replay.duplicated)
    assert replay.n_admitted == 50


def test_process_fleet_warm_spawn_and_rollover_over_the_wire(tmp_path):
    """With a populated registry every replica child starts through the
    warm pool (its WarmReport rides back in the hello: 0 builds), and the
    two-phase rollover ships the candidate bundle over the filesystem:
    prepare warms in every child, commit flips, the new month quotes."""
    from fm_returnprediction_tpu_torch.registry.store import using_registry
    from fm_returnprediction_tpu_torch.serving import ERService, ServingFleet, ingest_month

    rng = np.random.default_rng(1)
    state, y, x, mask = _fleet_state(rng)
    new_state = ingest_month(state, y[-1], x[-1], mask[-1],
                             np.datetime64("2035-01-31", "ns"), device="cpu")
    reg_dir = tmp_path / "registry"
    with using_registry(reg_dir):
        ERService(state, max_batch=32, auto_flush=False, device="cpu").close()
    fleet = ServingFleet(state, 2, replica_mode="process", transport="shm",
                         registry_dir=reg_dir, max_batch=32, device="cpu")
    try:
        assert set(fleet.warm_reports) == set(fleet.replica_states())
        assert all(r.zero_compile for r in fleet.warm_reports.values()), fleet.warm_reports
        assert fleet.rollover(new_state) == 1
        q = fleet.query(int(new_state.n_months - 1), np.zeros(state.n_predictors, np.float32))
        assert np.isfinite(q)
        st = fleet.replica("r0").service.stats()
        assert st["transport"] == "shm" and st["n_done"] >= 0
    finally:
        fleet.close()


# -- the spawned exchange rank --------------------------------------------------


def _exchange_rank(pid: int, nprocs: int, port: str) -> None:
    os.environ["FMRP_DIST_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["FMRP_DIST_PROCS"] = str(nprocs)
    os.environ["FMRP_DIST_PROC_ID"] = str(pid)
    os.environ["FMRP_DIST_JAX"] = "auto"
    from fm_returnprediction_tpu_torch import telemetry
    from fm_returnprediction_tpu_torch.parallel import distributed as dist
    from fm_returnprediction_tpu_torch.telemetry import identity

    assert dist.initialize_distributed() == (pid, nprocs)
    ex = dist.host_exchange()
    assert ex is not None and dist.dist_active()
    assert ex.allgather_obj(pid * 10) == [r * 10 for r in range(nprocs)]
    merged = ex.sum_tree({"gram": np.full((2, 3), float(pid + 1)), "n": np.array([pid])})
    assert np.array_equal(merged["gram"], np.full((2, 3), sum(r + 1.0 for r in range(nprocs))))
    assert merged["n"][0] == sum(range(nprocs))
    assert ex.broadcast_obj("root-truth" if pid == 0 else f"noise-{pid}") == "root-truth"
    ex.barrier("checkpoint")
    assert ex._m_rounds.value >= 4
    assert identity.process_index() == pid
    assert f'process_index="{pid}"' in telemetry.registry().to_prometheus()
    blocked = [m for m in sys.modules if m == "jax" or m.startswith("fm_returnprediction_tpu.")]
    assert not blocked, blocked
    dist.shutdown_distributed()
    print(f"EX_OK {pid}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "exchange":
        _exchange_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
