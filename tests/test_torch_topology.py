"""The port's topology controller against ``tests/test_topology.py``.

The eight controller cases: the spec's journal marks and ``FMRP_TOPO_*``
knobs (the reference package's marks, so either package reads the
other's), typed validation, the fd/segment hygiene sweep, the liveness
ladder (killed / hung / ring_stalled) on real replica processes with warm
respawns, SIGKILL mid result-send exactly once on both transports,
recovery of every declared shape from the journal alone (the thread shape
too, whose reference case is red: its executable plane serializes XLA
executables, the port's holds kernel libraries), the mixed shape with its
grid pool, and the autoscaler routed through the controller. Then the
reference file's other cases that the port's transport, multiprocess and
resilience files do not cover: deterministic chaos decisions 30 times over,
the writer dying at the ring's commit seam 30 times over, the exchange's
connect retry and its typed exhaustion, 30 rounds of the broker's fan-out
order, and a chaos-killed grid rank and a re-elected broker. Everything
runs on the CPU (``device="cpu"``); the 30-fold loops run in process."""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu_torch.parallel.shm import shm_available
from fm_returnprediction_tpu_torch.resilience.errors import InjectedFault
from fm_returnprediction_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    chaos_env,
    install_plan_from_env,
)
from fm_returnprediction_tpu_torch.topology import Member, TopologyController, TopologySpec

pytestmark = [pytest.mark.torch_port, pytest.mark.topology]

_SHM = pytest.mark.skipif(not shm_available(), reason="POSIX shared memory unavailable here")
_KW = dict(max_batch=16, max_latency_ms=2.0, device="cpu")


# -- the declarative spec ------------------------------------------------------


def test_spec_mark_roundtrip_counts_and_env(monkeypatch):
    from fm_returnprediction_tpu.topology import TopologySpec as JaxSpec

    spec = TopologySpec(replicas=3, replica_mode="process", transport="shm", grid_procs=2,
                        grid_transport="frames")
    assert TopologySpec.from_mark(spec.to_mark()) == spec
    assert json.loads(json.dumps(spec.to_mark())) == spec.to_mark()
    assert spec.counts() == {"router": 1, "replica_process": 3, "grid_worker": 2, "broker": 1}
    assert TopologySpec(replicas=1).counts()["broker"] == 0
    # the journal mark is the reference package's, both ways
    jax_spec = JaxSpec(replicas=3, replica_mode="process", transport="shm", grid_procs=2,
                       grid_transport="frames")
    assert spec.to_mark() == jax_spec.to_mark()
    assert TopologySpec.from_mark(jax_spec.to_mark()) == spec
    assert JaxSpec.from_mark(spec.to_mark()) == jax_spec
    monkeypatch.setenv("FMRP_TOPO_REPLICAS", "4")
    monkeypatch.setenv("FMRP_TOPO_REPLICA_MODE", "process")
    monkeypatch.setenv("FMRP_TOPO_TRANSPORT", "socket")
    monkeypatch.setenv("FMRP_TOPO_GRID_PROCS", "3")
    assert TopologySpec.from_env() == TopologySpec(
        replicas=4, replica_mode="process", transport="socket", grid_procs=3)
    assert TopologySpec.from_env().to_mark() == JaxSpec.from_env().to_mark()


def test_spec_validation_is_typed():
    with pytest.raises(ValueError, match="at least one replica"):
        TopologySpec(replicas=0)
    with pytest.raises(ValueError, match="replica_mode"):
        TopologySpec(replica_mode="fiber")
    with pytest.raises(ValueError, match="transport"):
        TopologySpec(transport="carrier-pigeon", replica_mode="process")
    with pytest.raises(ValueError, match="process replicas"):
        TopologySpec(replica_mode="thread", transport="shm")
    with pytest.raises(ValueError, match="grid_transport"):
        TopologySpec(grid_procs=2, grid_transport="nfs")
    with pytest.raises(ValueError, match="grid_procs"):
        TopologySpec(grid_procs=-1)


def test_member_rows_are_plain_data():
    m = Member(kind="router", ident="router", pid=1, status="live")
    assert (m.kind, m.status, m.detail) == ("router", "live", "")


# -- chaos decisions, the commit seam, hygiene ---------------------------------


def test_chaos_trigger_decisions_are_deterministic_30x():
    """The same (seed, site, call_no) decides the same way on every run:
    the parent's plan and a plan rebuilt from its env in a child fire
    identically, 30 rebuilds over."""
    spec = FaultSpec(probability=0.4, times=-1)
    with FaultPlan({"s": spec}, seed=13) as plan:
        env = chaos_env()
    baseline = [plan._should_fire(spec, n, "s") for n in range(1, 31)]
    assert 0 < sum(baseline) < 30
    for _ in range(30):
        rebuilt = install_plan_from_env({**env, "FMRP_DIST_PROC_ID": "1"})
        got = [rebuilt._should_fire(rebuilt.specs["s"], n, "s") for n in range(1, 31)]
        rebuilt.__exit__(None, None, None)
        assert got == baseline


@_SHM
def test_writer_death_at_commit_seam_leaves_no_frame_30x():
    """A writer dying between the payload/length stores and the commit word
    (the ``shm.ring.commit`` site) leaves a frame the reader never sees;
    the next send reuses the seat cleanly. 30 consecutive rounds."""
    from fm_returnprediction_tpu_torch.parallel.shm import ShmRing, attach_ring

    ring = ShmRing(create=True, slots=4, slot_bytes=256)
    try:
        reader = attach_ring(ring.name)
        for i in range(30):
            with FaultPlan({"shm.ring.commit": FaultSpec(times=1)}) as p:
                with pytest.raises(InjectedFault):
                    ring.send(f"torn-{i}".encode(), timeout_s=1.0)
                assert p.fired["shm.ring.commit"] == 1
            assert reader.recv(timeout_s=0.05) is None
            ring.send(f"clean-{i}".encode(), timeout_s=1.0)
            assert reader.recv(timeout_s=1.0) == f"clean-{i}".encode()
        reader.close()
    finally:
        ring.close()


@_SHM
def test_sweep_reclaims_abandoned_segments_and_doorbells():
    """Segments and doorbell fds abandoned without close are reclaimed by
    the controller's sweep and counted as leaks; a second sweep finds
    nothing, and a clean close leaks nothing."""
    from fm_returnprediction_tpu_torch import telemetry
    from fm_returnprediction_tpu_torch.parallel import shm as pshm
    from fm_returnprediction_tpu_torch.serving import shm as sshm

    pshm.sweep_segments()
    sshm.sweep_doorbells()
    seg_ctr = telemetry.registry().counter("fmrp_topology_leaked_segments_total")
    before = seg_ctr.value
    ring = pshm.ShmRing(create=True, slots=4, slot_bytes=128)
    bell = sshm._make_doorbell()
    leaked = TopologyController.sweep(None)
    assert ring.name in leaked["segments"]
    assert seg_ctr.value == before + 1
    if bell is not None:
        assert bell in leaked["fds"]
        with pytest.raises(OSError):
            os.fstat(bell)
    assert TopologyController.sweep(None) == {"segments": [], "fds": []}
    ring2 = pshm.ShmRing(create=True, slots=4, slot_bytes=128)
    ring2.close()
    assert TopologyController.sweep(None)["segments"] == []


# -- the exchange's connect path and the broker's fan-out ----------------------


def _cfg(port, world, rank):
    from fm_returnprediction_tpu_torch.parallel.distributed import DistConfig

    return DistConfig(coordinator=f"127.0.0.1:{port}", num_processes=world, process_id=rank)


def test_connect_retries_through_a_late_listener():
    """A rank that dials before the broker binds joins through its
    deterministic backoff instead of failing on the first refusal."""
    from fm_returnprediction_tpu_torch.parallel.distributed import HostExchange, free_port

    port = free_port()
    out = {}

    def late_rank1():
        ex = HostExchange(_cfg(port, 2, 1), timeout_s=30.0)
        try:
            out[1] = ex.allgather_obj("r1")
        finally:
            ex.close()

    t = threading.Thread(target=late_rank1)
    t.start()
    time.sleep(0.4)
    ex0 = HostExchange(_cfg(port, 2, 0), timeout_s=30.0)
    try:
        assert ex0.allgather_obj("r0") == ["r0", "r1"]
    finally:
        t.join(timeout=30)
        ex0.close()
    assert out[1] == ["r0", "r1"]


def test_connect_exhaustion_is_typed_with_retry_evidence():
    from fm_returnprediction_tpu_torch.parallel.distributed import (
        DistributedError,
        HostExchange,
        free_port,
    )
    from fm_returnprediction_tpu_torch.resilience.errors import RetryExhaustedError

    port = free_port()
    with pytest.raises(DistributedError, match="could not join") as ei:
        HostExchange(_cfg(port, 2, 1), timeout_s=0.5)
    assert isinstance(ei.value.__cause__, RetryExhaustedError)


def test_broker_fans_out_before_answering_rank0_30x():
    """30 consecutive rounds through the real broker in threads: every rank
    sees every round in rank order, none hangs or skews."""
    from fm_returnprediction_tpu_torch.parallel.distributed import HostExchange, free_port

    port = free_port()
    world, rounds = 3, 30
    got = {}

    def rank(r):
        ex = HostExchange(_cfg(port, world, r), timeout_s=60.0)
        try:
            got[r] = [ex.allgather_obj((r, k)) for k in range(rounds)]
        finally:
            ex.close()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(1, world)]
    for t in threads:
        t.start()
    rank(0)
    for t in threads:
        t.join(timeout=60)
    expect = [[(r, k) for r in range(world)] for k in range(rounds)]
    assert got == {r: expect for r in range(world)}


# -- the controller on real OS processes ---------------------------------------


def _tiny_state(rng, t=36, n=60, p=4):
    from fm_returnprediction_tpu_torch.serving import build_serving_state

    x = rng.standard_normal((t, n, p)).astype(np.float32)
    beta = (rng.standard_normal(p) * 0.05).astype(np.float32)
    y = (x @ beta + 0.1 * rng.standard_normal((t, n))).astype(np.float32)
    mask = rng.random((t, n)) > 0.2
    y = np.where(mask, y, np.nan).astype(np.float32)
    state = build_serving_state(torch.from_numpy(y), torch.from_numpy(x),
                                torch.from_numpy(mask), window=18, min_periods=9)
    return state, np.nonzero(state.have_coef())[0]


def _probe_until(ctl, rid, want, budget_s=20.0):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        probe = ctl.probe()
        if probe.get(rid) == want:
            return probe
        time.sleep(0.05)
    pytest.fail(f"{rid} never classified {want!r}: {ctl.probe()}")


def _marks(journal):
    return [json.loads(ln) for ln in journal.read_text().splitlines() if ln.strip()]


@_SHM
def test_probe_ladder_classifies_killed_hung_ring_stalled(tmp_path):
    """The ladder on real processes: a SIGSTOPped child with a clean ring
    is ``hung``, the same child with a frozen request-ring backlog is
    ``ring_stalled``, a SIGKILLed child is ``killed``; each is repaired by
    a warm respawn (no kernel build) with a journaled ``respawn`` mark."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet

    rng = np.random.default_rng(3)
    state, months = _tiny_state(rng)
    journal = tmp_path / "journal.jsonl"
    spec = TopologySpec(replicas=2, replica_mode="process", transport="shm")
    fleet = ServingFleet(state, 2, replica_mode="process", transport="shm",
                         journal=str(journal), registry_dir=str(tmp_path / "registry"), **_KW)
    ctl = TopologyController(spec, fleet=fleet, ping_timeout_s=0.5)
    try:
        assert fleet.topology is ctl
        assert all(v == "live" for v in ctl.probe().values())
        assert sorted(m.kind for m in ctl.members()) == [
            "replica_process", "replica_process", "router"]
        victim = sorted(fleet.replica_states())[0]
        svc = fleet.replica(victim).service
        os.kill(svc.pid, signal.SIGSTOP)
        _probe_until(ctl, victim, "hung")
        svc._channel.req_ring.send(b"backlog", timeout_s=1.0)
        probe = _probe_until(ctl, victim, "ring_stalled")
        stalled = {m.ident: m for m in ctl.members()}[victim]
        assert stalled.status == "ring_stalled" and "transport=shm" in stalled.detail
        actions = ctl.repair(probe)
        assert actions and actions[0].startswith(f"respawn:{victim}")
        assert ctl.repair() == []
        assert sorted(ctl.probe().values()) == ["live", "live"]
        victim2 = sorted(fleet.replica_states())[0]
        os.kill(fleet.replica(victim2).service.pid, signal.SIGKILL)
        probe = _probe_until(ctl, victim2, "killed")
        (action,) = ctl.repair(probe)
        new_rid = action.split("->")[1].split(":")[0]
        assert fleet.warm_reports[new_rid].builds == 0
        assert sorted(ctl.probe().values()) == ["live", "live"]
        from fm_returnprediction_tpu_torch import telemetry

        assert telemetry.registry().gauge("fmrp_topology_last_respawn_s").value > 0
        assert np.isfinite(fleet.query(int(months[0]), np.zeros(4, np.float32)))
        labels = [m.get("label") for m in _marks(journal) if m.get("ev") == "mark"]
        assert labels.count("respawn") == 2 and "topology" in labels
    finally:
        ctl.close()
    assert ctl.sweep() == {"segments": [], "fds": []}


@pytest.mark.parametrize("transport", [pytest.param("shm", marks=_SHM), "socket"])
def test_sigkill_mid_result_send_is_exactly_once(tmp_path, transport):
    """A chaos env makes replica 0 SIGKILL itself mid result-send (the
    socket's ``replica.result_send`` site, the shm ring's commit): the
    in-flight requests land exactly once through the survivor, the journal
    replays clean, and the controller's respawn quotes the same bits with
    no kernel build."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet, replay_journal

    rng = np.random.default_rng(5)
    state, months = _tiny_state(rng)
    journal = tmp_path / "journal.jsonl"
    spec = TopologySpec(replicas=2, replica_mode="process", transport=transport)
    site = "replica.result_send" if transport == "socket" else "shm.ring.commit"
    with FaultPlan({site: FaultSpec(times=1, sigkill=True, proc="0")}):
        fleet = ServingFleet(state, 2, replica_mode="process", transport=transport,
                             journal=str(journal), registry_dir=str(tmp_path / "registry"),
                             **_KW)
    ctl = TopologyController(spec, fleet=fleet, ping_timeout_s=1.0)
    try:
        qx = rng.standard_normal(4).astype(np.float32)
        month = int(months[0])
        futs = [fleet.submit(month, qx) for _ in range(8)]
        vals = [f.result(timeout=60) for f in futs]
        assert len(set(vals)) == 1 and np.isfinite(vals[0])
        dead = [r for r, s in ctl.probe().items() if s != "live"]
        assert len(dead) == 1, dead
        (action,) = ctl.repair()
        new_rid = action.split("->")[1].split(":")[0]
        assert fleet.warm_reports[new_rid].zero_compile, fleet.warm_reports[new_rid]
        assert fleet.query(month, qx) == vals[0]
        assert sorted(ctl.probe().values()) == ["live", "live"]
    finally:
        ctl.close()
    rep = replay_journal(journal)
    assert rep.clean, rep
    assert ctl.sweep() == {"segments": [], "fds": []}


@pytest.mark.parametrize("spec", [
    TopologySpec(replicas=2, replica_mode="thread"),
    pytest.param(TopologySpec(replicas=2, replica_mode="process", transport="shm"),
                 marks=_SHM),
    TopologySpec(replicas=1, replica_mode="process", transport="socket"),
], ids=["thread", "proc-shm", "proc-socket"])
def test_recover_rebuilds_the_declared_shape(tmp_path, spec):
    """Whole-controller crash with requests in flight: the journal's
    topology mark alone rebuilds the same declared shape (replica count,
    mode and transport), replaying clean, quoting the same bits, every
    replica started from the registry's warm pool without a build."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet

    rng = np.random.default_rng(11)
    state, months = _tiny_state(rng)
    journal = tmp_path / "journal.jsonl"
    reg_dir = tmp_path / "registry"
    fleet = ServingFleet(state, spec.replicas, replica_mode=spec.replica_mode,
                         transport=spec.transport, journal=str(journal),
                         registry_dir=str(reg_dir), **_KW)
    ctl = TopologyController(spec, fleet=fleet)
    qx = rng.standard_normal(4).astype(np.float32)
    month = int(months[0])
    before = fleet.query(month, qx)
    for _ in range(4):
        fleet.submit(month, qx)
    fleet.hard_crash()

    ctl2, report = TopologyController.recover(journal, state=state,
                                              registry_dir=str(reg_dir), **_KW)
    try:
        assert ctl2.spec == spec
        assert report.clean, report
        assert report.n_replicas == spec.replicas
        assert report.zero_compile_starts == spec.replicas, report
        assert ctl2.fleet.query(month, qx) == before
        assert report.journal.last_topology == spec.to_mark()
    finally:
        ctl2.close()
    assert ctl2.sweep() == {"segments": [], "fds": []}


@_SHM
def test_recover_mixed_shape_rebuilds_the_grid_pool(tmp_path):
    """Process replicas + a grid pool + its broker in one spec: recovery
    rebuilds the fleet from the journal and the pool from the supplied
    panel; the inventory lists every member kind and the rebuilt pool
    contracts correctly."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet

    rng = np.random.default_rng(17)
    state, months = _tiny_state(rng)
    journal = tmp_path / "journal.jsonl"
    t, n, p = 24, 40, 3
    gx = rng.standard_normal((t, n, p))
    gy = gx @ (0.1 * rng.standard_normal(p)) + 0.2 * rng.standard_normal((t, n))
    uni = np.ones((1, t, n), bool)
    spec = TopologySpec(replicas=1, replica_mode="process", transport="shm", grid_procs=2)
    fleet = ServingFleet(state, 1, replica_mode="process", transport="shm",
                         journal=str(journal), **_KW)
    TopologyController(spec, fleet=fleet)
    fleet.hard_crash()

    ctl2, report = TopologyController.recover(journal, state=state, panel=(gy, gx, uni),
                                              **_KW)
    try:
        assert ctl2.spec == spec and report.clean
        assert ctl2.pool is not None and ctl2.pool.device == "cpu"
        counts = {}
        for m in ctl2.members():
            counts[m.kind] = counts.get(m.kind, 0) + 1
        assert counts == {"router": 1, "replica_process": 1, "grid_worker": 2, "broker": 1}
        gram, _, count, _, _, _ = ctl2.pool.contract(
            np.zeros(1, np.int64), np.ones((1, p), bool), np.ones((1, t), bool))
        assert np.isfinite(gram).all()
        assert count.sum() == t * n
    finally:
        ctl2.close()
    assert ctl2.sweep() == {"segments": [], "fds": []}


def _grid_fixture(rng, t=24, n=40, p=3):
    x = rng.standard_normal((t, n, p))
    y = x @ (0.1 * rng.standard_normal(p)) + 0.2 * rng.standard_normal((t, n))
    return (y, x, np.ones((1, t, n), bool), np.zeros(1, np.int64), np.ones((1, p), bool),
            np.ones((1, t), bool))


def test_chaos_rank_death_inside_child_and_broker_reelection():
    """(a) A ``grid.rank_death`` SIGKILL targeted at worker 2 by env fires
    inside the child on its first job: the pool degrades to the disclosed
    N-1 world mid-contract. (b) A broker death mid-round
    (``dist.broker_round``) is re-elected — world respawned, round fanned
    out again — and the answer equals the pre-fault full world's bits."""
    from fm_returnprediction_tpu_torch import telemetry
    from fm_returnprediction_tpu_torch.specgrid import multiproc

    rng = np.random.default_rng(31)
    y, x, uni, uidx, col_sel, window = _grid_fixture(rng)
    with FaultPlan({"grid.rank_death": FaultSpec(times=1, sigkill=True, proc="2")}):
        pool = multiproc.SpecGridWorkerPool(3, y, x, uni, device="cpu")
    try:
        deg = pool.contract(uidx, col_sel, window)   # (gram, moment, n, ysum, yy, center)
        assert pool.degraded_ranks == (2,)
        assert deg[2].sum() < y.size
    finally:
        pool.close()

    reelect = telemetry.registry().counter("fmrp_topology_broker_reelections_total")
    before_ct = reelect.value
    pool = multiproc.SpecGridWorkerPool(2, y, x, uni, device="cpu")
    try:
        full = pool.contract(uidx, col_sel, window)
        with FaultPlan({"dist.broker_round": FaultSpec(times=1)}) as p:
            again = pool.contract(uidx, col_sel, window)
            assert p.fired["dist.broker_round"] == 1
        assert pool.degraded_ranks == ()
        assert reelect.value == before_ct + 1
        for a, b in zip(again, full):
            np.testing.assert_array_equal(a, b)
    finally:
        pool.close()


# -- the autoscaler routes through the controller ------------------------------


def test_autoscale_routes_through_the_topology_controller(tmp_path):
    """With a controller attached, the supervisor's scale-out updates the
    declared spec and journals a fresh topology mark, the record recovery
    rebuilds from."""
    from fm_returnprediction_tpu_torch.serving import (
        AdmissionPolicy,
        AutoscalePolicy,
        ServingFleet,
    )

    rng = np.random.default_rng(37)
    state, months = _tiny_state(rng)
    journal = tmp_path / "journal.jsonl"
    clk = [1000.0]
    fleet = ServingFleet(
        state, 1, max_batch=8, max_queue=8, auto_flush=False, journal=str(journal),
        admission=AdmissionPolicy(max_occupancy=1.01),
        autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2, cooldown_s=10.0,
                                  out_occupancy=0.5, in_occupancy=0.2, in_ticks=2),
        admission_clock=lambda: clk[0], device="cpu",
    )
    assert fleet.topology is None
    ctl = TopologyController(TopologySpec(replicas=1, replica_mode="thread"), fleet=fleet)
    try:
        qx = rng.standard_normal(4).astype(np.float32)
        futs = [fleet.submit(int(months[0]), qx) for _ in range(6)]
        actions = fleet.supervisor.tick()
        assert any(a.startswith("scale-out:+1") for a in actions), actions
        assert ctl.spec.replicas == 2
        topo = [json.loads(m["topo"]) for m in _marks(journal)
                if m.get("ev") == "mark" and m.get("label") == "topology"]
        assert topo[-1]["replicas"] == 2
        fleet.flush_all()
        for f in futs:
            f.result(timeout=10)
    finally:
        ctl.close()
