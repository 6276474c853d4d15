"""The port's serving fleet (``ServingFleet(device="cpu")``) vs the JAX
package's, on the CPU, held to ``tests/test_fleet.py``'s contracts.

The same seeded panel (48 months × 40 firms × 3 predictors) is built into
a serving state by each package; ``auto_flush=False`` and injected clocks
keep every test deterministic.

- **Routing.** ``HashRing`` sends the same keys to the same replica ids in
  both packages (sha256 points), and consistency under removal holds.
- **Bits.** A fleet of one is bit-identical to the bare service in each
  package; the port's fleet answers JAX's fleet at rtol 1e-12 on a float64
  state (the service pin of ``tests/test_torch_serving.py``).
- **Journals.** Under ``auto_flush=False`` the two packages write the same
  event sequence for the same kill, shed and rollover episodes; each
  package replays the other's journal to the same verdict.
- **Supervision.** ``tick()`` takes the same actions in both packages
  (drain and replace a poisoned replica, kill and fail over a dead
  flusher).
- **Failover through the registry.** The reference's zero-compile
  failover test is red on this tree
  (``tests/test_fleet.py::test_chaos_failover_restores_quoting_with_zero_compiles``),
  so the port's counterpart pins the port's own contract: every replica,
  the replacement included, starts through the warm pool with 0 builds.
- **Release.** A replica that leaves drops its bucket programs and its
  state on the device. ``replica_mode="process"`` (by argument or by
  ``FMRP_FLEET_REPLICA_MODE``) builds a fleet of spawned replica processes
  whose quotes are bit-equal to the thread fleet's; an unknown mode raises.
"""

from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from fm_returnprediction_tpu.resilience.faults import FaultSpec as JaxFaultSpec
from fm_returnprediction_tpu.resilience.faults import fleet_kill_routed as jax_kill_routed
from fm_returnprediction_tpu.resilience.faults import (
    poison_serving_state_nan as jax_poison_state,
)
from fm_returnprediction_tpu.serving import AdmissionPolicy as JaxAdmission
from fm_returnprediction_tpu.serving import ERService as JaxService
from fm_returnprediction_tpu.serving import HashRing as JaxRing
from fm_returnprediction_tpu.serving import ServingFleet as JaxFleet
from fm_returnprediction_tpu.serving import TokenBucket as JaxBucket
from fm_returnprediction_tpu.serving import build_serving_state as jax_build
from fm_returnprediction_tpu.serving import fleet_smoke as jax_fleet_smoke
from fm_returnprediction_tpu.serving import ingest_month as jax_ingest
from fm_returnprediction_tpu.serving import replay_journal as jax_replay
from fm_returnprediction_tpu.serving.supervisor import HealthPolicy as JaxHealth
from fm_returnprediction_tpu_torch.registry import Registry
from fm_returnprediction_tpu_torch.registry import artifacts as rart
from fm_returnprediction_tpu_torch.resilience.errors import (
    InjectedFault,
    ServiceOverloadError,
    StateRolloverError,
)
from fm_returnprediction_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    fleet_kill_routed,
    fleet_stall_replica,
    fleet_trigger_staged_rollover,
    poison_serving_state_nan,
)
from fm_returnprediction_tpu_torch.serving import (
    AdmissionPolicy,
    ERService,
    HashRing,
    RequestJournal,
    ServingFleet,
    ServingState,
    TokenBucket,
    build_serving_state,
    fleet_smoke,
    ingest_month,
    replay_journal,
)
from fm_returnprediction_tpu_torch.serving.supervisor import (
    DEAD,
    DRAINING,
    HEALTHY,
    HealthPolicy,
)

pytestmark = pytest.mark.torch_port

T, N, P = 48, 40, 3
WINDOW, MIN_PERIODS = 16, 8
NEW_MONTH = np.datetime64("2031-01-31", "ns")


def _make_panel(seed=2015, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, P)).astype(dtype)
    beta = np.array([0.05, -0.02, 0.01], dtype=dtype)
    y = (x @ beta + 0.02 * rng.standard_normal((T, N))).astype(dtype)
    mask = rng.random((T, N)) > 0.1
    y = np.where(mask, y, np.nan).astype(dtype)
    x = np.where(mask[..., None], x, np.nan).astype(dtype)
    return y, x, mask


def _queries(x):
    rng = np.random.default_rng(7)
    months = rng.integers(T // 2, T, 120)
    firms = rng.integers(0, N, 120)
    return months, x[months, firms]


def _to_port(jax_state) -> ServingState:
    return ServingState(**{f.name: getattr(jax_state, f.name)
                           for f in dataclasses.fields(ServingState)})


@pytest.fixture(scope="module")
def case():
    """The f32 case: each package's own state from the same numpy panel."""
    y, x, mask = _make_panel()
    state = build_serving_state(torch.from_numpy(y), torch.from_numpy(x),
                                torch.from_numpy(mask), window=WINDOW,
                                min_periods=MIN_PERIODS)
    jstate = jax_build(y, x, mask, window=WINDOW, min_periods=MIN_PERIODS)
    months, qx = _queries(x)
    return y, x, mask, state, jstate, months, qx


def _oracle(service_cls, state, months, qx, **kw):
    with service_cls(state, max_batch=8, auto_flush=False, **kw) as ref:
        futs = [ref.submit(int(m), q) for m, q in zip(months, qx)]
        ref.batcher.drain()
        return np.asarray([f.result(timeout=5) for f in futs])


def _journal_lines(path):
    return [json.loads(line) for line in open(path)]


# -- routing -------------------------------------------------------------------


@pytest.mark.parametrize("vnodes,members", [(64, ("r0", "r1")), (32, ("r0", "r1", "r2")),
                                            (8, ("r3", "r5", "r9", "r12"))])
def test_hash_ring_routes_like_the_jax_ring(vnodes, members):
    ring, jring = HashRing(vnodes=vnodes), JaxRing(vnodes=vnodes)
    for rid in members:
        ring.add(rid)
        jring.add(rid)
    keys = [f"k{i}" for i in range(300)] + [str(i) for i in range(1, 200)]
    assert [ring.route(k) for k in keys] == [jring.route(k) for k in keys]
    excl = {members[0]}
    assert [ring.route(k, exclude=excl) for k in keys] == \
        [jring.route(k, exclude=excl) for k in keys]
    before = {k: ring.route(k) for k in keys}
    ring.remove(members[-1])
    for k in keys:
        if before[k] != members[-1]:
            assert ring.route(k) == before[k]
    assert ring.route("k0", exclude=set(members)) is None


def test_token_bucket_refills_like_the_jax_bucket():
    clk = [0.0]
    tb = TokenBucket(rate_per_s=4.0, burst=2.0, clock=lambda: clk[0])
    jtb = JaxBucket(rate_per_s=4.0, burst=2.0, clock=lambda: clk[0])
    seen = []
    for step in (0.0, 0.0, 0.0, 0.25, 10.0, 0.0, 0.0, 0.1):
        clk[0] += step
        seen.append((tb.try_acquire(), jtb.try_acquire()))
    assert [a for a, _ in seen] == [b for _, b in seen]
    assert seen[2][0] == pytest.approx(0.25)


# -- bits ----------------------------------------------------------------------


@pytest.mark.parametrize("package", ["port", "jax"])
def test_fleet_of_one_bit_identical_to_bare_service(package, case):
    *_, state, jstate, months, qx = case
    if package == "port":
        fleet_cls, svc_cls, st, kw = ServingFleet, ERService, state, {"device": "cpu"}
    else:
        fleet_cls, svc_cls, st, kw = JaxFleet, JaxService, jstate, {}
    want = _oracle(svc_cls, st, months, qx, **kw)
    with fleet_cls(st, 1, max_batch=8, auto_flush=False, **kw) as fleet:
        futs = [fleet.submit(int(m), q) for m, q in zip(months, qx)]
        fleet.flush_all()
        got = np.asarray([f.result(timeout=5) for f in futs])
    assert np.array_equal(got, want, equal_nan=True)


def test_fleet_quotes_match_the_jax_fleet_at_float64():
    y, x, mask = _make_panel(dtype=np.float64)
    jstate = jax_build(y, x, mask, window=WINDOW, min_periods=MIN_PERIODS)
    months, qx = _queries(x)
    with JaxFleet(jstate, 2, max_batch=8, auto_flush=False) as jfleet:
        futs = [jfleet.submit(int(m), q) for m, q in zip(months, qx)]
        jfleet.flush_all()
        want = np.asarray([f.result(timeout=5) for f in futs])
    with ServingFleet(_to_port(jstate), 2, max_batch=8, auto_flush=False,
                      device="cpu") as fleet:
        futs = [fleet.submit(int(m), q) for m, q in zip(months, qx)]
        fleet.flush_all()
        got = np.asarray([f.result(timeout=5) for f in futs])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)
    assert np.isfinite(got).sum() > 60


def test_fleet_smoke_matches_the_jax_smoke(case):
    *_, state, jstate, _, _ = case
    got = fleet_smoke(state, 2, n_queries=64, max_batch=16, device="cpu")
    want = jax_fleet_smoke(jstate, 2, n_queries=64, max_batch=16)
    keys = ("fleet_size", "n_queries", "finite_quotes", "healthy_replicas", "agg_n_done",
            "shed_total")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["finite_quotes"] == 64


# -- exactly-once: journals ----------------------------------------------------


def _kill_episode(fleet_cls, plan_cls, spec_cls, kill, state, months, qx, journal, **kw):
    with fleet_cls(state, 2, max_batch=8, auto_flush=False, journal=journal, **kw) as fleet:
        with plan_cls({"fleet.replica_kill": spec_cls(skip=20, times=1,
                                                      mutate=kill())}) as plan:
            futs = [fleet.submit(int(m), q) for m, q in zip(months, qx)]
        assert plan.fired["fleet.replica_kill"] == 1
        for _ in range(4):
            fleet.flush_all()
        got = np.asarray([f.result(timeout=5) for f in futs])
        stats = fleet.stats()
        actions = fleet.supervisor.tick()
        post_fut = fleet.submit(int(months[0]), qx[0])
        fleet.flush_all()
        post = post_fut.result(timeout=5)
    return got, stats, actions, post


def test_kill_under_load_writes_the_jax_journal(case, tmp_path):
    """The same deterministic mid-flight kill in both packages: the same
    journal, line for line; zero dropped, zero duplicated, requeues > 0;
    the dead replica's counters folded into the aggregate; the same
    failover action; the port's answers equal the bare service's bits."""
    *_, state, jstate, months, qx = case
    want = _oracle(ERService, state, months, qx, device="cpu")
    got, stats, actions, post = _kill_episode(
        ServingFleet, FaultPlan, FaultSpec, fleet_kill_routed, state, months, qx,
        tmp_path / "port.jsonl", device="cpu")
    _, jstats, jactions, _ = _kill_episode(
        JaxFleet, JaxFaultPlan, JaxFaultSpec, jax_kill_routed, jstate, months, qx,
        tmp_path / "jax.jsonl")
    assert _journal_lines(tmp_path / "port.jsonl") == _journal_lines(tmp_path / "jax.jsonl")
    assert actions == jactions and actions[0].startswith("failover:")
    for key in ("requeues_total", "dead_replicas", "agg_n_done", "failovers_total"):
        assert stats[key] == jstats[key], key
    assert stats["requeues_total"] > 0 and stats["agg_n_done"] == len(months)
    assert np.array_equal(got, want, equal_nan=True) and post == want[0]
    replay = replay_journal(tmp_path / "port.jsonl")
    assert replay.clean and replay.n_requeues > 0 and replay.n_admitted == replay.n_done


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_replays_the_others_journal(writer, case, tmp_path):
    *_, state, jstate, months, qx = case
    path = tmp_path / "j.jsonl"
    if writer == "port":
        _kill_episode(ServingFleet, FaultPlan, FaultSpec, fleet_kill_routed, state, months,
                      qx, path, device="cpu")
    else:
        _kill_episode(JaxFleet, JaxFaultPlan, JaxFaultSpec, jax_kill_routed, jstate,
                      months, qx, path)
    mine, theirs = replay_journal(path), jax_replay(path)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.clean and mine.n_admitted == len(months) + 1


def test_swap_under_load_journal_proves_exactly_once(case, tmp_path):
    """Four client threads; ``fleet.swap_mid_flight`` fires a staged
    two-phase rollover between two admits; every request resolves, the
    journal replays clean, and the answers equal the bare service's (old
    months are identical across versions)."""
    y, x, mask, state, _, months, qx = case
    want = _oracle(ERService, state, months, qx, device="cpu")
    new_state = ingest_month(state, y[-1], x[-1], mask[-1], NEW_MONTH, device="cpu")
    journal = tmp_path / "swap.jsonl"
    results = np.empty(len(months))
    with ServingFleet(state, 2, max_batch=8, max_latency_ms=1.0, journal=journal,
                      device="cpu") as fleet:
        fleet.stage_rollover(new_state)
        with FaultPlan({"fleet.swap_mid_flight": FaultSpec(
                skip=len(months) // 2, times=1,
                mutate=fleet_trigger_staged_rollover)}) as plan:
            def worker(lo, hi):
                for k in range(lo, hi):
                    results[k] = fleet.query(int(months[k]), qx[k])

            threads = [threading.Thread(target=worker, args=(k * 30, (k + 1) * 30))
                       for k in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        assert plan.fired["fleet.swap_mid_flight"] == 1
        assert fleet.drain(timeout=10) and fleet.version == 1
        assert all(r["state"] == HEALTHY for r in fleet.stats()["replicas"].values())
    assert np.array_equal(results, want, equal_nan=True)
    replay = replay_journal(journal)
    assert replay.clean and replay.n_admitted == len(months) == replay.n_done
    marks = [m["label"] for m in replay.marks]
    assert "rollover_begin" in marks and "rollover_commit" in marks


def test_journal_verdicts_equal_the_jax_verdicts_on_a_bad_file(tmp_path):
    path = tmp_path / "bad.jsonl"
    lines = [
        {"seq": 1, "ev": "admit", "req": 1},
        {"seq": 2, "ev": "route", "req": 1, "replica": "r0"},
        {"seq": 3, "ev": "admit", "req": 2},
        {"seq": 4, "ev": "route", "req": 2, "replica": "r0"},
        {"seq": 5, "ev": "done", "req": 2},
        {"seq": 6, "ev": "done", "req": 2},
        {"seq": 7, "ev": "route", "req": 3},
        {"seq": 8, "ev": "shed", "req": 4},
        {"seq": 9, "ev": "bogus", "req": 5},
    ]
    with open(path, "w") as fh:
        for rec in lines:
            fh.write(json.dumps(rec) + "\n")
        fh.write('{"seq": 10, "ev": "admit", "req":')
    replay = replay_journal(path)
    assert dataclasses.asdict(replay) == dataclasses.asdict(jax_replay(path))
    assert replay.dropped == (1, 3) and replay.duplicated == (2,) and not replay.clean
    assert any("torn" in v for v in replay.invalid)


def test_journal_rotates_a_reused_path(tmp_path):
    path = tmp_path / "j.jsonl"
    with RequestJournal(path) as j1:
        assert j1.rotated_to is None
        for ev, kw in (("admit", {}), ("route", {"replica": "r0"}), ("done", {})):
            j1.append(ev, 1, **kw)
    with RequestJournal(path) as j2:
        rotated = j2.rotated_to
        assert rotated is not None and rotated.exists()
        j2.append("admit", 1)
        j2.append("shed", 1)
    assert replay_journal(path).clean and replay_journal(rotated).clean
    assert replay_journal(path).n_shed == 1 and replay_journal(rotated).n_done == 1


def test_raising_fault_site_cannot_strand_accounting(case, tmp_path):
    *_, state, _, months, qx = case
    journal = tmp_path / "raise.jsonl"
    with ServingFleet(state, 1, max_batch=8, auto_flush=False, journal=journal,
                      device="cpu") as fleet:
        with FaultPlan({"fleet.swap_mid_flight": FaultSpec(times=1)}):
            with pytest.raises(InjectedFault):
                fleet.submit(int(months[0]), qx[0])
        assert fleet.drain(timeout=1)
        ok = fleet.submit(int(months[1]), qx[1])
        fleet.flush_all()
        assert isinstance(ok.result(timeout=5), float)
    replay = replay_journal(journal)
    assert replay.clean and replay.n_error == 1 and replay.n_done == 1


# -- admission -----------------------------------------------------------------


def _shed_episode(fleet_cls, admission_cls, state, months, qx, journal, **kw):
    clk = [0.0]
    with fleet_cls(state, 1, max_batch=8, auto_flush=False, journal=journal,
                   admission=admission_cls(rate_per_s=10.0, burst=2.0),
                   admission_clock=lambda: clk[0], **kw) as fleet:
        futs = [fleet.submit(int(months[k]), qx[k]) for k in range(2)]
        with pytest.raises(Exception) as err:
            fleet.submit(int(months[2]), qx[2])
        clk[0] += err.value.retry_after_s
        futs.append(fleet.submit(int(months[2]), qx[2]))
        fleet.flush_all()
        for f in futs:
            f.result(timeout=5)
        return err.value, fleet.stats()["shed_total"]


def test_token_bucket_shed_retry_success_as_the_jax_fleet(case, tmp_path):
    *_, state, jstate, months, qx = case
    err, shed = _shed_episode(ServingFleet, AdmissionPolicy, state, months, qx,
                              tmp_path / "p.jsonl", device="cpu")
    jerr, jshed = _shed_episode(JaxFleet, JaxAdmission, jstate, months, qx,
                                tmp_path / "j.jsonl")
    assert isinstance(err, ServiceOverloadError) and err.reason == "token_bucket"
    assert (err.retry_after_s, err.reason, shed) == (jerr.retry_after_s, jerr.reason, jshed)
    assert _journal_lines(tmp_path / "p.jsonl") == _journal_lines(tmp_path / "j.jsonl")
    replay = replay_journal(tmp_path / "p.jsonl")
    assert replay.clean and replay.n_shed == 1 and replay.n_done == 3


def test_occupancy_shed_carries_queue_evidence(case):
    *_, state, _, months, qx = case
    with ServingFleet(state, 2, max_batch=8, max_queue=4, auto_flush=False,
                      admission=AdmissionPolicy(max_occupancy=0.75), device="cpu") as fleet:
        futs = [fleet.submit(int(months[k]), qx[k]) for k in range(6)]
        with pytest.raises(ServiceOverloadError) as err:
            fleet.submit(int(months[6]), qx[6])
        assert err.value.reason == "queue_occupancy"
        assert (err.value.queue_depth, err.value.queue_ceiling) == (6, 8)
        assert err.value.occupancy == pytest.approx(0.75) and err.value.retry_after_s > 0
        fleet.flush_all()
        retry = fleet.submit(int(months[6]), qx[6])
        fleet.flush_all()
        for f in [*futs, retry]:
            assert isinstance(f.result(timeout=5), float)


# -- rollover ------------------------------------------------------------------


def test_poisoned_rollover_aborts_with_zero_flips_as_the_jax_fleet(case, tmp_path):
    y, x, mask, state, jstate, months, qx = case
    want = _oracle(ERService, state, months, qx, device="cpu")
    marks = {}
    for name, fleet_cls, plan_cls, spec_cls, poison, st, new, kw in (
        ("port", ServingFleet, FaultPlan, FaultSpec, poison_serving_state_nan, state,
         ingest_month(state, y[-1], x[-1], mask[-1], NEW_MONTH, device="cpu"),
         {"device": "cpu"}),
        ("jax", JaxFleet, JaxFaultPlan, JaxFaultSpec, jax_poison_state, jstate,
         jax_ingest(jstate, y[-1], x[-1], mask[-1], NEW_MONTH), {}),
    ):
        journal = tmp_path / f"{name}.jsonl"
        with fleet_cls(st, 2, max_batch=8, auto_flush=False, journal=journal,
                       **kw) as fleet:
            with plan_cls({"fleet.poison_state": spec_cls(skip=1, times=1,
                                                          mutate=poison)}) as plan:
                with pytest.raises(Exception, match="no replica flipped"):
                    fleet.rollover(new)
            assert plan.fired["fleet.poison_state"] == 1 and fleet.version == 0
            if name == "port":
                futs = [fleet.submit(int(m), q) for m, q in zip(months, qx)]
                fleet.flush_all()
                got = np.asarray([f.result(timeout=5) for f in futs])
                assert np.array_equal(got, want, equal_nan=True)
            assert fleet.rollover(new) == 1
        marks[name] = [(m["label"], m.get("replica"), m.get("version"))
                       for m in replay_journal(journal).marks]
    assert marks["port"] == marks["jax"]
    assert [m[0] for m in marks["port"]].count("rollover_commit") == 1


def test_rollover_rejects_a_non_append_candidate(case):
    *_, state, _, _, _ = case
    shrunk = dataclasses.replace(state, **{
        f: getattr(state, f)[:-1] for f in ("months", "coef", "month_valid", "slopes_bar",
                                            "intercept_bar", "x_lo", "x_hi", "gram",
                                            "moment", "n_obs", "ysum", "yy")})
    with ServingFleet(state, 1, max_batch=8, auto_flush=False, device="cpu") as fleet:
        with pytest.raises(StateRolloverError, match="backwards"):
            fleet.rollover(shrunk)
        assert fleet.version == 0


# -- supervision ---------------------------------------------------------------


def _poisoned_replica_episode(fleet_cls, health_cls, state, months, qx, **kw):
    out = []
    with fleet_cls(state, 2, max_batch=8, auto_flush=False,
                   health=health_cls(max_quarantined_months=0, consecutive_breaches=1),
                   **kw) as fleet:
        victim = sorted(fleet.replica_states())[0]
        rep = fleet.replica(victim)
        assert not rep.service.ingest_month(
            np.full(N, np.nan), np.full((N, P), np.nan, np.float32), np.ones(N, bool),
            np.datetime64("2070-01-31", "ns"))
        out.append(fleet.supervisor.tick())
        out.append(fleet.replica_states()[victim])
        futs = [fleet.submit(int(months[k]), qx[k]) for k in range(10)]
        out.append(fleet.replica(victim).service.batcher.queue_depth)
        fleet.flush_all()
        for f in futs:
            f.result(timeout=5)
        out.append(fleet.supervisor.tick())
        stats = fleet.stats()
        out.append((stats["healthy_replicas"], stats["failovers_total"],
                    sorted(stats["replaced"])))
    return out


def test_supervisor_drains_and_replaces_as_the_jax_supervisor(case):
    *_, state, jstate, months, qx = case
    got = _poisoned_replica_episode(ServingFleet, HealthPolicy, state, months, qx,
                                    device="cpu")
    want = _poisoned_replica_episode(JaxFleet, JaxHealth, jstate, months, qx)
    assert got == want
    assert got[0][0].startswith("drain:r0:quarantined_months") and got[1] == DRAINING
    assert got[2] == 0 and got[3] == ["replace:r0->r2"] and got[4] == (2, 1, ["r0"])


def _dead_flusher_episode(fleet_cls, state, **kw):
    with fleet_cls(state, 2, max_batch=8, **kw) as fleet:
        victim = sorted(fleet.replica_states())[0]
        fleet.replica(victim).service.batcher.close()
        first = fleet.supervisor.tick()
        dead = fleet.replica_states()[victim]
        second = fleet.supervisor.tick()
        return first, dead, second, fleet.stats()["healthy_replicas"]


def test_dead_flusher_is_killed_and_failed_over_as_in_jax(case):
    *_, state, jstate, _, _ = case
    got = _dead_flusher_episode(ServingFleet, state, device="cpu")
    assert got == _dead_flusher_episode(JaxFleet, jstate)
    assert got[0] == ["kill:r0:heartbeat:flusher-dead"] and got[1] == DEAD
    assert got[2] == ["failover:r0->r2"] and got[3] == 2


def test_stalled_replica_trips_the_watchdog_and_drains(case):
    *_, state, _, months, qx = case
    with ServingFleet(state, 2, max_batch=8, auto_flush=False, dispatch_timeout_s=0.15,
                      health=HealthPolicy(max_dispatch_timeout_rate=0.0,
                                          consecutive_breaches=1), device="cpu") as fleet:
        victim = sorted(fleet.replica_states())[0]
        with FaultPlan({"fleet.replica_stall": FaultSpec(
                times=-1, mutate=fleet_stall_replica(victim, 0.5))}):
            futs = [fleet.submit(int(months[k]), qx[k]) for k in range(12)]
            for _ in range(3):
                fleet.flush_all()
        assert len([f.result(timeout=5) for f in futs]) == 12
        assert fleet.stats()["requeues_total"] > 0
        actions = fleet.supervisor.tick()
        assert any(a.startswith(f"drain:{victim}") for a in actions)
    # the watchdog abandoned the stalled dispatches: let them end before the
    # process may exit (a thread inside a torch op at exit aborts it)
    for th in threading.enumerate():
        if th.name == "fmrp-serving-dispatch":
            th.join(timeout=10)


def test_failover_through_the_registry_starts_every_replica_build_free(case, tmp_path):
    """The port's warm-pool contract (the reference's test of this is red):
    with a registry armed, every replica start, the failover replacement
    included, has a ``WarmReport`` with 0 builds and one capture per
    bucket, and quoting through the replacement keeps the bare service's
    bits."""
    *_, state, _, months, qx = case
    reg_dir = tmp_path / "registry"
    rart.put_serving_state(state, "fleet-test", registry=Registry(reg_dir))
    with ServingFleet(state, 2, max_batch=8, auto_flush=False, registry_dir=reg_dir,
                      device="cpu") as fleet:
        assert sorted(fleet.warm_reports) == ["r0", "r1"]
        victim = "r0"
        with FaultPlan({"fleet.replica_kill": FaultSpec(
                times=1, mutate=fleet_kill_routed(victim))}):
            futs = [fleet.submit(int(months[k]), qx[k]) for k in range(20)]
        for _ in range(3):
            fleet.flush_all()
        for f in futs:
            f.result(timeout=5)
        assert fleet.supervisor.tick() == [f"failover:{victim}->r2"]
        for rid, report in fleet.warm_reports.items():
            assert report.zero_compile and report.builds == 0, (rid, report)
            assert report.captures == len(fleet.replica("r1").service.executor.buckets())
        want = _oracle(ERService, state, months[:20], qx[:20], device="cpu")
        futs = [fleet.submit(int(months[k]), qx[k]) for k in range(20)]
        fleet.flush_all()
        assert np.array_equal(np.asarray([f.result(timeout=5) for f in futs]), want,
                              equal_nan=True)


# -- release, instrumentation, knobs -------------------------------------------


def test_a_replica_that_leaves_releases_its_executors(case):
    *_, state, _, months, qx = case
    with ServingFleet(state, 2, max_batch=8, auto_flush=False, device="cpu") as fleet:
        dead = fleet.replica("r0").service
        assert dead.executor._buckets and dead.executor._state_args
        fleet.kill_replica("r0", reason="test")
        assert not dead.executor._buckets and dead.executor._state_args == ()
        fleet.supervisor.tick()
        retired = fleet.replica("r1").service
        fleet.replace("r1", reason="test")
        assert not retired.executor._buckets and retired.executor._state_args == ()
        assert dead.stats()["n_done"] == 0        # counters still read
        f = fleet.submit(int(months[0]), qx[0])
        fleet.flush_all()
        assert isinstance(f.result(timeout=5), float)


def test_prometheus_per_replica_labels_and_fleet_gauges(case):
    *_, state, _, months, qx = case
    with ServingFleet(state, 2, max_batch=8, auto_flush=False, device="cpu") as fleet:
        f = fleet.submit(int(months[0]), qx[0])
        fleet.flush_all()
        f.result(timeout=5)
        text = fleet.prometheus_metrics()
    for family in ("fmrp_serving_requests_done_total",
                   "fmrp_serving_executable_cache_hits_total"):
        assert f'{family}{{replica="r0"}}' in text and f'{family}{{replica="r1"}}' in text
    for gauge in ("fmrp_fleet_healthy_replicas 2", "fmrp_fleet_size 2",
                  "fmrp_fleet_service_version 0", "# HELP fmrp_fleet_healthy_replicas"):
        assert gauge in text


def test_fleet_env_knobs(case, monkeypatch):
    *_, state, _, _, _ = case
    monkeypatch.setenv("FMRP_FLEET_SIZE", "3")
    monkeypatch.setenv("FMRP_FLEET_RATE", "50")
    monkeypatch.setenv("FMRP_FLEET_BURST", "7")
    monkeypatch.setenv("FMRP_FLEET_SHED_OCCUPANCY", "0.5")
    policy = AdmissionPolicy.from_env()
    assert (policy.rate_per_s, policy.burst, policy.max_occupancy) == (50.0, 7.0, 0.5)
    with ServingFleet(state, max_batch=8, auto_flush=False, device="cpu") as fleet:
        assert fleet.stats()["fleet_size"] == 3 and fleet._bucket is not None


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_process_replicas_raise_naming_roadmap_item_8(how, case, monkeypatch):
    """Process replicas are ported (the name is kept from when they
    raised): a process fleet of 2 on the CPU, asked for by argument or by
    environment, quotes bit-equal to the thread fleet of 2; an unknown
    replica mode still raises."""
    *_, state, _, months, qx = case
    months, qx = months[:16], qx[:16]
    kw = {"replica_mode": "process"}
    if how == "environment":
        monkeypatch.setenv("FMRP_FLEET_REPLICA_MODE", "process")
        kw = {}
    with ServingFleet(state, 2, max_batch=8, device="cpu", replica_mode="thread") as fleet:
        want = fleet.query_many(months.tolist(), qx)
    with ServingFleet(state, 2, max_batch=8, device="cpu", **kw) as fleet:
        assert fleet.replica_mode == "process"
        assert all(fleet.replica(r).service.pid for r in fleet.replica_states())
        got = fleet.query_many(months.tolist(), qx)
    assert np.isfinite(want).sum() > len(want) // 2
    assert np.array_equal(got, want, equal_nan=True)
    with pytest.raises(ValueError, match="not 'thread'"):
        ServingFleet(state, 2, max_batch=8, device="cpu", replica_mode="fiber")


def test_single_service_swap_state_publishes_behind_a_warm_executor(case):
    y, x, mask, state, _, months, qx = case
    want = _oracle(ERService, state, months, qx, device="cpu")
    new_state = ingest_month(state, y[-1], x[-1], mask[-1], NEW_MONTH, device="cpu")
    with ERService(state, max_batch=8, auto_flush=False, device="cpu") as svc:
        svc.swap_state(new_state)
        assert svc.state is new_state
        futs = [svc.submit(int(m), q) for m, q in zip(months, qx)]
        svc.batcher.drain()
        got = np.asarray([f.result(timeout=5) for f in futs])
        assert svc.stats()["executable_cache_misses"] == 0
    assert np.array_equal(got, want, equal_nan=True)
