"""The port's overload machinery vs the JAX package's, on the CPU, held to
``tests/test_fleet_overload.py``'s contracts: the autoscaler leg, the
brownout ladder, crash-restart recovery, journal retention, the retry-hint
consumer, the load harness and the portfolio consumer.

The same seeded panel (48 months × 40 firms × 4 predictors) is built into
a serving state by each package; the supervisor's clock is injected and
``auto_flush=False``, so every ``tick()`` is deterministic.

- **Brownout.** ``degraded_project`` answers the same bits as the
  reference on both rungs: the bf16 rung rounds through ``torch.bfloat16``
  where the reference rounds through ``ml_dtypes`` (both round to nearest
  even); ``_keep_and_bound`` returns the same keep mask and bound; the
  controller walks the same ladder.
- **The supervisor.** The same ``tick()`` actions in both packages for
  scale-out, scale-in, cooldown, the brownout ladder and its gates.
- **Recovery.** ``repair_journal`` and ``recover_journal`` leave the same
  bytes and the same verdicts on the same torn files. The reference's
  hard-crash test through the registry is red on this tree
  (``tests/test_fleet_overload.py::test_hard_crash_recover_replays_clean_and_serves_again``),
  so the port's counterpart pins the port's own contract: the crashed
  fleet is fenced, the journal replays clean, every recovered replica
  starts with 0 builds, and quoting resumes with the pre-crash bits.
- **The consumer.** ``portfolio_consumer`` forms the same books as the
  reference, its quotes bit-identical to the batch executor's
  (``min_bucket=2``, ``tests/test_backtest.py:501-505``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.serving import AdmissionPolicy as JaxAdmission
from fm_returnprediction_tpu.serving import AutoscalePolicy as JaxAutoscale
from fm_returnprediction_tpu.serving import BrownoutPolicy as JaxBrownoutPolicy
from fm_returnprediction_tpu.serving import LoadGen as JaxLoadGen
from fm_returnprediction_tpu.serving import LoadPhase as JaxLoadPhase
from fm_returnprediction_tpu.serving import ServingFleet as JaxFleet
from fm_returnprediction_tpu.serving import build_serving_state as jax_build
from fm_returnprediction_tpu.serving import portfolio_consumer as jax_consumer
from fm_returnprediction_tpu.serving.brownout import BrownoutController as JaxController
from fm_returnprediction_tpu.serving.brownout import _keep_and_bound as jax_keep_and_bound
from fm_returnprediction_tpu.serving.brownout import degraded_project as jax_degraded
from fm_returnprediction_tpu.serving.recovery import recover_journal as jax_recover_journal
from fm_returnprediction_tpu.serving.recovery import repair_journal as jax_repair
from fm_returnprediction_tpu_torch.registry import Registry
from fm_returnprediction_tpu_torch.registry import artifacts as rart
from fm_returnprediction_tpu_torch.resilience.errors import (
    RetryExhaustedError,
    ServiceOverloadError,
)
from fm_returnprediction_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    fleet_hard_crash,
    tear_journal_tail,
)
from fm_returnprediction_tpu_torch.resilience.retry import RetryPolicy
from fm_returnprediction_tpu_torch.serving import (
    AdmissionPolicy,
    AutoscalePolicy,
    BrownoutPolicy,
    BucketedExecutor,
    DegradedQuote,
    ERService,
    LoadGen,
    LoadPhase,
    RequestJournal,
    ServingFleet,
    ServingState,
    build_serving_state,
    capacity_model,
    ingest_month,
    portfolio_consumer,
    query_with_retry,
    replay_journal,
)
from fm_returnprediction_tpu_torch.serving.brownout import (
    BrownoutController,
    _keep_and_bound,
    degraded_project,
)
from fm_returnprediction_tpu_torch.serving.recovery import recover_journal, repair_journal
from fm_returnprediction_tpu_torch.serving.supervisor import DRAINING

pytestmark = pytest.mark.torch_port

T, N, P = 48, 40, 4
WINDOW, MIN_PERIODS = 16, 8


def _make_panel(seed=2016):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, P)).astype(np.float32)
    beta = (rng.standard_normal(P) * 0.05).astype(np.float32)
    y = (x @ beta + 0.02 * rng.standard_normal((T, N))).astype(np.float32)
    mask = rng.random((T, N)) > 0.1
    y = np.where(mask, y, np.nan).astype(np.float32)
    x = np.where(mask[..., None], x, np.nan).astype(np.float32)
    return y, x, mask


@pytest.fixture(scope="module")
def case():
    y, x, mask = _make_panel()
    state = build_serving_state(torch.from_numpy(y), torch.from_numpy(x),
                                torch.from_numpy(mask), window=WINDOW,
                                min_periods=MIN_PERIODS)
    jstate = jax_build(y, x, mask, window=WINDOW, min_periods=MIN_PERIODS)
    rng = np.random.default_rng(11)
    months = rng.integers(T // 2, T, 100)
    qx = x[months, rng.integers(0, N, 100)]
    return y, x, mask, state, jstate, months, qx


def _to_port(jax_state) -> ServingState:
    """The JAX state's leaves as a port state: where a test holds answers
    bit for bit, both packages quote the same arrays (the two packages'
    own f32 fits differ in the last bits)."""
    return ServingState(**{f.name: getattr(jax_state, f.name)
                           for f in dataclasses.fields(ServingState)})


PORT = dict(fleet=ServingFleet, admission=AdmissionPolicy, autoscale=AutoscalePolicy,
            brownout=BrownoutPolicy, kw={"device": "cpu"})
JAX = dict(fleet=JaxFleet, admission=JaxAdmission, autoscale=JaxAutoscale,
           brownout=JaxBrownoutPolicy, kw={})


# -- brownout ------------------------------------------------------------------


@pytest.mark.parametrize("rung,m", [("bf16", None), ("coreset", 1), ("coreset", 2),
                                    ("coreset", None), ("coreset", 4)])
def test_degraded_projection_is_the_jax_projection_bit_for_bit(rung, m, case):
    *_, jstate, months, qx = case
    state = _to_port(jstate)
    for k in range(len(months)):
        idx = state.month_index(int(months[k]))
        got = degraded_project(state, idx, qx[k], rung, m=m)
        want = jax_degraded(jstate, idx, qx[k], rung, m=m)
        assert isinstance(got, DegradedQuote)
        assert np.array_equal(np.float64(got), np.float64(want), equal_nan=True), k
        assert got.disclosure() == want.disclosure()


def test_bf16_rounding_matches_ml_dtypes_everywhere():
    import ml_dtypes

    from fm_returnprediction_tpu_torch.serving.brownout import _round_bf16

    rng = np.random.default_rng(0)
    a = (rng.standard_normal(200_000) * np.exp(rng.uniform(-40, 40, 200_000))).astype(
        np.float32)
    a = np.concatenate([a, np.array([np.inf, -np.inf, 0.0, -0.0, 3.39e38, 1e-40, -1e-45,
                                     1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8], np.float32)])
    want = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(_round_bf16(a).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_keep_and_bound_equal_the_jax_selection(m, case):
    *_, state, _, _, _ = case
    keep, bound = _keep_and_bound(state.slopes_bar, state.x_lo, state.x_hi, m)
    jkeep, jbound = jax_keep_and_bound(state.slopes_bar, state.x_lo, state.x_hi, m)
    assert np.array_equal(keep, jkeep) and np.array_equal(bound, jbound, equal_nan=True)


def test_coreset_bound_zero_slope_against_unbounded_support():
    with np.errstate(invalid="raise"):
        keep, bound = _keep_and_bound(np.array([[0.5, 0.0]]), np.array([[-1.0, -np.inf]]),
                                      np.array([[1.0, np.inf]]), m=1)
    assert keep[0].tolist() == [True, False] and bound[0] == 0.0
    _, bound = _keep_and_bound(np.array([[0.5, 0.2]]), np.array([[-1.0, -np.inf]]),
                               np.array([[1.0, np.inf]]), m=1)
    assert np.isinf(bound[0])


def test_brownout_controller_walks_the_jax_ladder():
    kw = dict(ladder=("full", "coreset", "shed"), enter_burn=2.0, exit_burn=1.0,
              enter_occupancy=0.9, exit_occupancy=0.3, dwell_ticks=2, recover_ticks=2)
    ctl, jctl = BrownoutController(BrownoutPolicy(**kw)), JaxController(JaxBrownoutPolicy(**kw))
    hot = dict(burn=3.0, occupancy=0.0, scale_exhausted=True)
    calm = dict(burn=0.0, occupancy=0.0, scale_exhausted=True)
    mid = dict(burn=1.5, occupancy=0.0, scale_exhausted=True)
    early = dict(burn=9.9, occupancy=1.0, scale_exhausted=False)
    script = [early, hot, hot, hot, hot, hot, calm, mid, calm, calm, calm, calm]
    got = [(ctl.update(**s), ctl.level) for s in script]
    assert got == [(jctl.update(**s), jctl.level) for s in script]
    assert [a for a, _ in got if a] == ["brownout:coreset", "brownout:shed",
                                        "recover:coreset", "recover:full"]
    assert not ctl.active


def test_policy_knobs_reconcile_or_reject_as_in_jax(monkeypatch):
    for env in ({"FMRP_FLEET_MIN": "8"}, {"FMRP_FLEET_MAX": "2"}, {}):
        assert AutoscalePolicy.from_env(env) == (
            None if not env else AutoscalePolicy(**dataclasses.asdict(
                JaxAutoscale.from_env(env))))
    with pytest.raises(ValueError, match="contradictory"):
        AutoscalePolicy.from_env({"FMRP_FLEET_MIN": "8", "FMRP_FLEET_MAX": "2"})
    for ladder, match in ((("full", "shed", "coreset"), "end at 'shed'"),
                          (("full", "shed", "coreset", "shed"), "interior rung"),
                          (("full", "coreset", "coreset", "shed"), "duplicate")):
        with pytest.raises(ValueError, match=match):
            BrownoutPolicy(ladder=ladder)
    with pytest.raises(ValueError, match="coreset_m"):
        BrownoutPolicy(coreset_m=0)
    env = {"FMRP_FLEET_BROWNOUT_LADDER": "full,bf16,shed", "FMRP_FLEET_BROWNOUT_BURN": "3",
           "FMRP_FLEET_BROWNOUT_M": "2", "FMRP_FLEET_BROWNOUT_RECOVER_TICKS": "5"}
    assert dataclasses.asdict(BrownoutPolicy.from_env(env)) == \
        dataclasses.asdict(JaxBrownoutPolicy.from_env(env))


# -- the supervisor's overload legs, against the JAX package -------------------


def _scale_episode(pkg, state, months, qx):
    clk = [1000.0]
    fleet = pkg["fleet"](
        state, 1, max_batch=8, max_queue=8, auto_flush=False,
        admission=pkg["admission"](max_occupancy=1.01),
        autoscale=pkg["autoscale"](min_replicas=1, max_replicas=2, cooldown_s=10.0,
                                   out_occupancy=0.5, in_occupancy=0.2, in_ticks=2),
        admission_clock=lambda: clk[0], **pkg["kw"])
    log = []
    try:
        futs = [fleet.submit(int(months[k]), qx[k]) for k in range(6)]
        log.append(fleet.supervisor.tick())
        clk[0] += 11.0
        log.append(fleet.supervisor.tick())
        fleet.flush_all()
        for f in futs:
            f.result(timeout=5)
        clk[0] += 11.0
        log += [fleet.supervisor.tick(), fleet.supervisor.tick()]
        log.append(fleet.stats()["draining_replicas"])
        log.append(fleet.supervisor.tick())
        stats = fleet.stats()
        log.append({k: stats[k] for k in ("healthy_replicas", "fleet_size", "scale_in_total",
                                          "scale_out_total", "replaced")})
    finally:
        fleet.close()
    return log


def test_scale_out_on_pressure_and_scale_in_on_relief_as_in_jax(case):
    *_, state, jstate, months, qx = case
    got = _scale_episode(PORT, state, months, qx)
    assert got == _scale_episode(JAX, jstate, months, qx)
    assert got[0] and got[0][0].startswith("scale-out:+1")
    assert got[3] == ["scale-in:r1"] and got[5] == ["retire:r1"]
    assert got[6]["healthy_replicas"] == 1 and got[6]["scale_in_total"] == 1


def _cooldown_episode(pkg, state, months, qx):
    clk = [0.0]
    fleet = pkg["fleet"](
        state, 1, max_batch=8, max_queue=4, auto_flush=False,
        admission=pkg["admission"](max_occupancy=1.01),
        autoscale=pkg["autoscale"](min_replicas=1, max_replicas=3, cooldown_s=30.0,
                                   out_occupancy=0.5),
        admission_clock=lambda: clk[0], **pkg["kw"])
    try:
        futs = [fleet.submit(int(months[k]), qx[k]) for k in range(3)]
        log = [fleet.supervisor.tick()]
        futs += [fleet.submit(int(months[k]), qx[k]) for k in range(3, 6)]
        log.append(fleet.supervisor.tick())
        clk[0] += 30.0
        log.append(fleet.supervisor.tick())
        log.append(fleet.stats()["healthy_replicas"])
        fleet.flush_all()
        for f in futs:
            f.result(timeout=5)
    finally:
        fleet.close()
    return log


def test_autoscale_cooldown_is_deterministic_under_an_injected_clock(case):
    *_, state, jstate, months, qx = case
    got = _cooldown_episode(PORT, state, months, qx)
    assert got == _cooldown_episode(JAX, jstate, months, qx)
    assert got[1] == [] and got[2][0].startswith("scale-out") and got[3] == 3


def _ladder_episode(pkg, state, months, qx, journal):
    fleet = pkg["fleet"](
        state, 2, max_batch=8, max_queue=8, auto_flush=False,
        admission=pkg["admission"](max_occupancy=1.01), journal=journal,
        brownout=pkg["brownout"](ladder=("full", "coreset", "shed"), enter_burn=1e9,
                                 exit_burn=1.0, enter_occupancy=0.5, exit_occupancy=0.2,
                                 dwell_ticks=1, recover_ticks=2), **pkg["kw"])
    log = []
    try:
        queued = [fleet.submit(int(months[k]), qx[k]) for k in range(10)]
        log.append(fleet.supervisor.tick())
        depth = fleet._queue_snapshot()[0]
        quote = fleet.query(int(months[0]), qx[0])
        log.append((float(quote), quote.route, quote.m, quote.err_bound,
                    fleet._queue_snapshot()[0] == depth, fleet.stats()["degraded_total"]))
        log.append(fleet.supervisor.tick())
        try:
            fleet.submit(int(months[1]), qx[1])
        except Exception as exc:  # noqa: BLE001 — compared below
            log.append((type(exc).__name__, exc.reason, exc.retry_after_s))
        fleet.flush_all()
        for f in queued:
            f.result(timeout=5)
        log += [fleet.supervisor.tick() for _ in range(4)]
        fut = fleet.submit(int(months[0]), qx[0])
        fleet.flush_all()
        full = fut.result(timeout=5)
        log.append(type(full).__name__)
    finally:
        fleet.close()
    return log, quote, full


def test_brownout_ladder_end_to_end_as_in_jax(case, tmp_path):
    """Pressure with scale-out exhausted: coreset answers (disclosed,
    host-side, queue untouched), then the shed rung's typed 429, then
    hysteretic recovery; the same log and the same journal as the
    reference, the degraded quote within its bound of the full one."""
    *_, jstate, months, qx = case
    got, quote, full = _ladder_episode(PORT, _to_port(jstate), months, qx,
                                       tmp_path / "p.jsonl")
    want, _, _ = _ladder_episode(JAX, jstate, months, qx, tmp_path / "j.jsonl")
    assert got == want
    assert got[0] == ["brownout:coreset"] and got[2] == ["brownout:shed"]
    assert got[1][1:3] == ("coreset", (P + 1) // 2) and got[1][4]
    assert got[3][:2] == ("ServiceOverloadError", "brownout_shed")
    assert got[4:8] == [[], ["recover:coreset"], [], ["recover:full"]] and got[8] == "float"
    assert abs(full - float(quote)) <= quote.err_bound + 1e-4 * (1 + abs(full))
    lines = [json.loads(ln) for ln in open(tmp_path / "p.jsonl")]
    assert lines == [json.loads(ln) for ln in open(tmp_path / "j.jsonl")]
    replay = replay_journal(tmp_path / "p.jsonl")
    assert replay.clean and replay.n_shed == 1
    assert [m["label"] for m in replay.marks].count("brownout") == 4


def test_degraded_routes_bypass_occupancy_shedding(case):
    *_, state, _, months, qx = case
    fleet = ServingFleet(state, 1, max_batch=8, max_queue=8, auto_flush=False,
                         brownout=BrownoutPolicy(ladder=("full", "coreset", "shed"),
                                                 enter_burn=1e9, exit_burn=1.0,
                                                 enter_occupancy=0.5, exit_occupancy=0.1,
                                                 dwell_ticks=1, recover_ticks=2),
                         device="cpu")
    try:
        queued = [fleet.submit(int(months[k]), qx[k]) for k in range(7)]
        assert fleet.supervisor.tick() == ["brownout:coreset"]
        for k in range(7, 12):
            assert isinstance(fleet.query(int(months[k]), qx[k]), DegradedQuote)
        assert fleet._queue_snapshot()[0] == 7 and fleet.stats()["shed_total"] == 0
        assert fleet.supervisor.tick() == ["brownout:shed"]
        with pytest.raises(ServiceOverloadError) as err:
            fleet.submit(int(months[0]), qx[0])
        assert err.value.reason == "brownout_shed"
        fleet.flush_all()
        for f in queued:
            f.result(timeout=5)
    finally:
        fleet.close()


def test_relief_scale_in_is_gated_while_brownout_is_active(case):
    *_, state, _, months, qx = case
    clk = [0.0]
    fleet = ServingFleet(
        state, 2, max_batch=8, max_queue=8, auto_flush=False,
        admission=AdmissionPolicy(max_occupancy=1.01),
        autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2, cooldown_s=1.0,
                                  out_occupancy=0.5, in_occupancy=0.3, in_ticks=1),
        brownout=BrownoutPolicy(ladder=("full", "coreset", "shed"), enter_burn=1e9,
                                exit_burn=1.0, enter_occupancy=0.5, exit_occupancy=0.1,
                                dwell_ticks=1, recover_ticks=10),
        admission_clock=lambda: clk[0], device="cpu")
    try:
        queued = [fleet.submit(int(months[k]), qx[k]) for k in range(10)]
        assert fleet.supervisor.tick() == ["brownout:coreset"]
        fleet.flush_all()
        for f in queued:
            f.result(timeout=5)
        for _ in range(4):
            clk[0] += 2.0
            assert not any(a.startswith("scale-in") for a in fleet.supervisor.tick())
        assert fleet.stats()["healthy_replicas"] == 2
        fleet.brownout.level = 0
        clk[0] += 2.0
        assert any(a.startswith("scale-in") for a in fleet.supervisor.tick())
    finally:
        fleet.close()


def test_scale_out_bounds_live_replicas_not_just_healthy(case):
    *_, state, _, months, qx = case
    fleet = ServingFleet(state, 2, max_batch=8, max_queue=8, auto_flush=False,
                         admission=AdmissionPolicy(max_occupancy=1.01),
                         autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2,
                                                   cooldown_s=0.0, out_occupancy=0.2),
                         device="cpu")
    try:
        fleet.decommission("r0", reasons=["synthetic breach"])
        assert fleet.replica_states()["r0"] == DRAINING
        futs = [fleet.submit(int(months[k]), qx[k]) for k in range(4)]
        assert not any(a.startswith("scale-out") for a in fleet.supervisor.tick())
        fleet.flush_all()
        for f in futs:
            f.result(timeout=5)
        fleet.supervisor.tick()
        assert len(fleet.replica_states()) == 2
    finally:
        fleet.close()


def test_env_knobs_arm_autoscale_and_brownout(case, monkeypatch):
    *_, state, _, _, _ = case
    for k, v in (("FMRP_FLEET_MIN", "2"), ("FMRP_FLEET_MAX", "5"),
                 ("FMRP_FLEET_COOLDOWN_S", "7.5"), ("FMRP_FLEET_BROWNOUT", "1"),
                 ("FMRP_FLEET_BROWNOUT_M", "2"),
                 ("FMRP_FLEET_BROWNOUT_LADDER", "full,bf16,shed")):
        monkeypatch.setenv(k, v)
    pol = AutoscalePolicy.from_env()
    assert (pol.min_replicas, pol.max_replicas, pol.cooldown_s) == (2, 5, 7.5)
    with ServingFleet(state, 2, max_batch=8, auto_flush=False, device="cpu") as fleet:
        assert fleet.supervisor.autoscale == pol
        assert fleet.brownout.policy.coreset_m == 2
        assert fleet.brownout.policy.ladder == ("full", "bf16", "shed")


def test_tick_failover_serializes_with_the_rollover_lock(case):
    y, x, mask, state, _, _, _ = case
    new_state = ingest_month(state, y[-1], x[-1], mask[-1],
                             np.datetime64("2031-01-31", "ns"), device="cpu")
    fleet = ServingFleet(state, 2, max_batch=8, auto_flush=False, device="cpu")
    try:
        fleet.kill_replica("r0", reason="pre-rollover corpse")
        started, done = threading.Event(), {}

        def roll():
            with FaultPlan({"fleet.poison_state": FaultSpec(times=-1, delay_s=0.4)}):
                started.set()
                done["version"] = fleet.rollover(new_state)

        th = threading.Thread(target=roll)
        th.start()
        started.wait(timeout=5)
        time.sleep(0.05)
        t0 = time.perf_counter()
        actions = fleet.supervisor.tick()
        waited = time.perf_counter() - t0
        th.join(timeout=10)
        assert done.get("version") == 1 and actions == ["failover:r0->r2"]
        assert waited >= 0.1
        assert all(fleet.replica(r).service.state is new_state
                   for r in fleet.replica_states())
    finally:
        fleet.close()


# -- crash-restart recovery ----------------------------------------------------


def _torn_files(tmp_path):
    lines = [{"seq": 1, "ev": "mark", "label": "fleet_start", "size": 2},
             {"seq": 2, "ev": "admit", "req": 1},
             {"seq": 3, "ev": "route", "req": 1, "replica": "r0"},
             {"seq": 4, "ev": "done", "req": 1},
             {"seq": 5, "ev": "admit", "req": 2},
             {"seq": 6, "ev": "route", "req": 2, "replica": "r1"},
             {"seq": 7, "ev": "requeue", "req": 2, "replica": "r1"},
             {"seq": 8, "ev": "admit", "req": 3},
             {"seq": 9, "ev": "mark", "label": "scale_out", "size": 3}]
    body = "".join(json.dumps(rec, sort_keys=True) + "\n" for rec in lines)
    return {
        "torn": body + '{"seq": 10, "ev": "adm',
        "newline_cut": body.rstrip("\n"),
        "clean": body,
        "empty": "",
    }


@pytest.mark.parametrize("shape", ["torn", "newline_cut", "clean", "empty"])
def test_repair_and_recover_leave_the_jax_bytes_and_verdicts(shape, tmp_path):
    text = _torn_files(tmp_path)[shape]
    for name in ("port", "jax", "port_rec", "jax_rec"):
        (tmp_path / f"{name}.jsonl").write_text(text)
    assert repair_journal(tmp_path / "port.jsonl") == jax_repair(tmp_path / "jax.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    got = recover_journal(tmp_path / "port_rec.jsonl")
    want = jax_recover_journal(tmp_path / "jax_rec.jsonl")
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    g.pop("path"), w.pop("path")
    assert g == w
    assert (tmp_path / "port_rec.jsonl").read_bytes() == \
        (tmp_path / "jax_rec.jsonl").read_bytes()
    if shape != "empty":
        assert got.replay_clean and [r.req for r in got.recovered] == [2, 3]
        assert got.last_size == 3 and got.torn_lines == (1 if shape == "torn" else 0)


def test_hard_crash_recover_fences_replays_clean_and_serves_again(case, tmp_path):
    """The port's contract for the reference's red scenario: the
    ``fleet.hard_crash`` site abandons the fleet with requests in flight
    and ``fleet.journal_torn_tail`` tears its last line; the crashed
    replicas are fenced (released) before anything else runs;
    ``ServingFleet.recover`` repairs the tail, closes out the in-flight
    requests, sizes the fleet from the journal, starts every replica from
    the registry with 0 builds, and quotes the pre-crash bits."""
    *_, state, _, months, qx = case
    reg_dir = tmp_path / "registry"
    rart.put_serving_state(state, "crash-test", registry=Registry(reg_dir))
    journal = tmp_path / "crash.jsonl"
    fleet = ServingFleet(state, 2, max_batch=8, auto_flush=False, registry_dir=reg_dir,
                         journal=journal, device="cpu")
    fleet.scale_out(1, reason="pre-crash topology")
    services = [fleet.replica(r).service for r in fleet.replica_states()]
    with FaultPlan({"fleet.hard_crash": FaultSpec(skip=12, times=1, mutate=fleet_hard_crash),
                    "fleet.journal_torn_tail": FaultSpec(times=1,
                                                         corrupt=tear_journal_tail)}) as plan:
        for k in range(20):
            try:
                fleet.submit(int(months[k]), qx[k])
            except Exception:  # noqa: BLE001 — submits after the crash fail
                pass
    assert plan.fired["fleet.hard_crash"] == 1 and plan.fired["fleet.journal_torn_tail"] == 1
    assert all(not s.executor._buckets and s.executor._state_args == () for s in services)
    assert not replay_journal(journal).clean
    with ERService(state, max_batch=8, auto_flush=False, device="cpu") as ref:
        futs = [ref.submit(int(m), q) for m, q in zip(months[:20], qx[:20])]
        ref.batcher.drain()
        want = np.asarray([f.result(timeout=5) for f in futs])
    recovered, report = ServingFleet.recover(journal, registry_dir=reg_dir, max_batch=8,
                                             auto_flush=False, device="cpu")
    try:
        assert report.journal.torn_lines == 1 and len(report.journal.recovered) >= 12
        assert report.clean and report.n_replicas == 3
        assert report.state_source == f"registry:{reg_dir}"
        assert report.zero_compile_starts == 3
        assert all(r.builds == 0 for r in recovered.warm_reports.values())
        rotated = replay_journal(report.rotated_to)
        assert rotated.clean and report.rotated_to.name in report.prior_sessions
        futs = [recovered.submit(int(m), q) for m, q in zip(months[:20], qx[:20])]
        recovered.flush_all()
        got = np.asarray([f.result(timeout=5) for f in futs])
        assert np.array_equal(got, want, equal_nan=True)
    finally:
        recovered.close()
    assert replay_journal(journal).clean


def test_recover_requires_a_state_source(tmp_path, monkeypatch):
    monkeypatch.delenv("FMRP_REGISTRY_DIR", raising=False)
    journal = tmp_path / "j.jsonl"
    with RequestJournal(journal) as j:
        j.append("admit", 1)
        j.append("shed", 1)
    with pytest.raises(ValueError, match="registry"):
        ServingFleet.recover(journal, device="cpu")


def test_recover_with_an_explicit_state_closes_out_in_flight(case, tmp_path):
    *_, state, _, _, _ = case
    journal = tmp_path / "j.jsonl"
    with RequestJournal(journal) as j:
        j.mark("fleet_start", size=1)
        for ev, kw in (("admit", {}), ("route", {"replica": "r0"}), ("done", {})):
            j.append(ev, 1, **kw)
        j.append("admit", 2)
    fleet, report = ServingFleet.recover(journal, state=state, max_batch=8,
                                         auto_flush=False, device="cpu")
    try:
        assert report.state_source == "explicit" and report.clean and report.n_replicas == 1
        assert [(r.req, r.last_event) for r in report.journal.recovered] == [(2, "admit")]
    finally:
        fleet.close()


def test_journal_retention_keeps_the_newest_and_discloses_drops(tmp_path):
    path = tmp_path / "j.jsonl"
    for session in range(4):
        with RequestJournal(path, keep=2) as j:
            j.append("admit", 1)
            j.append("route", 1, replica="r0", session=session)
            j.append("done", 1)
    with RequestJournal(path, keep=2) as j:
        assert j.rotated_to == path.with_name("j.jsonl.4")
        assert sorted(p.name for _, p in j.sessions()) == ["j.jsonl.3", "j.jsonl.4"]
        assert [p.name for p in j.dropped_sessions] == ["j.jsonl.2"]
    assert replay_journal(path.with_name("j.jsonl.4")).clean
    assert "journal_retention" in [m["label"] for m in replay_journal(path).marks]


# -- the retry-hint consumer and the load harness ------------------------------


def test_query_with_retry_consumes_the_retry_after_hint(case):
    *_, state, _, months, qx = case
    clk, slept = [0.0], []

    def fake_sleep(s):
        slept.append(s)
        clk[0] += s

    fleet = ServingFleet(state, 1, max_batch=8,
                         admission=AdmissionPolicy(rate_per_s=10.0, burst=1.0),
                         admission_clock=lambda: clk[0], device="cpu")
    try:
        assert isinstance(query_with_retry(fleet, int(months[0]), qx[0], sleep=fake_sleep),
                          float) and not slept
        assert isinstance(query_with_retry(fleet, int(months[1]), qx[1], sleep=fake_sleep),
                          float)
        assert len(slept) == 1 and slept[0] >= 0.1 - 1e-9
        assert fleet.stats()["shed_total"] == 1
    finally:
        fleet.close()


def test_query_with_retry_exhausts_with_the_last_429_as_cause(case):
    *_, state, _, months, qx = case
    clk = [0.0]
    fleet = ServingFleet(state, 1, max_batch=8, auto_flush=False,
                         admission=AdmissionPolicy(rate_per_s=0.001, burst=1.0),
                         admission_clock=lambda: clk[0], device="cpu")
    try:
        fleet.submit(int(months[0]), qx[0])
        with pytest.raises(RetryExhaustedError) as err:
            query_with_retry(fleet, int(months[1]), qx[1],
                             policy=RetryPolicy(max_attempts=2, backoff_s=0.001,
                                                retry_on=(ServiceOverloadError,)),
                             sleep=lambda s: None)
        assert isinstance(err.value.__cause__, ServiceOverloadError)
        fleet.flush_all()
    finally:
        fleet.close()


def test_loadgen_accounts_every_request_with_typed_outcomes(case, tmp_path):
    *_, state, _, months, qx = case
    journal = tmp_path / "load.jsonl"
    fleet = ServingFleet(state, 2, max_batch=16, max_latency_ms=1.0, journal=journal,
                         device="cpu")
    try:
        report = LoadGen(fleet, months, qx, seed=7).run([
            LoadPhase("burst", n_requests=60, workers=4),
            LoadPhase("hot", n_requests=40, workers=4, hot_key_frac=0.8),
            LoadPhase("poison", n_requests=40, workers=4, poison_frac=0.25),
        ])
        assert report["n"] == 140
        for phase in report["phases"]:
            assert sum(phase[k] for k in ("ok", "degraded", "shed", "poison_rejected",
                                          "errors")) == phase["n"]
        poison = report["phases"][2]
        assert poison["poison_rejected"] > 0 and poison["errors"] == 0 and poison["ok"] > 0
        fleet.drain(timeout=10)
    finally:
        fleet.close()
    assert replay_journal(journal).clean


def test_loadgen_streams_and_ramps_are_the_jax_harness(case):
    """The same seeded stream: the same phase picks (the same poison and
    hot flags) and the same ramp schedule as the reference's harness."""
    *_, state, jstate, months, qx = case
    fleet = ServingFleet(state, 1, max_batch=8, auto_flush=False, device="cpu")
    jfleet = JaxFleet(jstate, 1, max_batch=8, auto_flush=False)
    try:
        gen, jgen = LoadGen(fleet, months, qx, seed=3), JaxLoadGen(jfleet, months, qx, seed=3)
        phase = LoadPhase("ramp", n_requests=50, rate_per_s=1000.0, ramp=True)
        jphase = JaxLoadPhase("ramp", n_requests=50, rate_per_s=1000.0, ramp=True)
        sched = gen._schedule(phase, t0=0.0)
        np.testing.assert_array_equal(sched, jgen._schedule(jphase, t0=0.0))
        gaps = np.diff(sched)
        assert (gaps >= 0).all() and gaps[:24].mean() > gaps[24:].mean()
        assert gen._schedule(LoadPhase("burst", 5), t0=0.0) is None
    finally:
        fleet.close()
        jfleet.close()


def test_loadgen_second_run_reports_only_its_own_traffic(case):
    *_, state, _, months, qx = case
    fleet = ServingFleet(state, 1, max_batch=8, max_latency_ms=1.0, device="cpu")
    try:
        gen = LoadGen(fleet, months, qx, seed=9)
        first = gen.run([LoadPhase("a", n_requests=10, workers=2)])
        second = gen.run([LoadPhase("b", n_requests=6, workers=2)])
        assert first["n"] == 10 and second["n"] == 6
        assert [p["phase"] for p in second["phases"]] == ["b"] and len(gen.phase_reports) == 2
        fleet.drain(timeout=10)
    finally:
        fleet.close()


def test_capacity_model_reads_the_ledger_and_holds_the_measured_rate(case, monkeypatch):
    from fm_returnprediction_tpu_torch import telemetry

    *_, state, _, months, qx = case
    fleet = ServingFleet(state, 2, max_batch=16, max_latency_ms=1.0, device="cpu")
    try:
        model = capacity_model(fleet)
        assert model["predicted_rows_per_s"] > 0 and model["healthy_replicas"] == 2
        assert model["bucket"] == 16 and model["dispatch_s"] > 0
        # the bucket's analytic cost (BucketedExecutor._cost): 2·P FLOPs a row
        assert model["flops_per_row"] == 2 * P and model["bytes_per_row"] > 0
        report = LoadGen(fleet, months, qx, seed=5).run(
            [LoadPhase("probe", n_requests=80, workers=8)])
        measured = report["phases"][0]["rows_per_s"]
        assert measured is not None and 0 < measured <= model["predicted_rows_per_s"] * 10
        # the card's byte roofline, at a rate low enough to bind
        monkeypatch.setattr(telemetry, "peak_bandwidth_estimate", lambda: 1e6)
        assert capacity_model(fleet)["roofline_rows_per_s"] == \
            pytest.approx(1e6 / model["bytes_per_row"], rel=1e-3)
        fleet.drain(timeout=10)
    finally:
        fleet.close()


def test_portfolio_consumer_books_match_jax_and_quotes_the_batch_executor(tmp_path):
    t, n, p = 48, 40, 3
    rng = np.random.default_rng(2015)
    x = rng.standard_normal((t, n, p)).astype(np.float32)
    y = (x @ np.array([0.05, -0.02, 0.01], np.float32)
         + 0.02 * rng.standard_normal((t, n))).astype(np.float32)
    mask = rng.random((t, n)) > 0.1
    y = np.where(mask, y, np.nan).astype(np.float32)
    x = np.where(mask[..., None], x, np.nan).astype(np.float32)
    state = build_serving_state(torch.from_numpy(y), torch.from_numpy(x),
                                torch.from_numpy(mask), window=16, min_periods=8)
    jstate = jax_build(y, x, mask, window=16, min_periods=8)
    months = np.flatnonzero(state.have_coef())[-3:]
    journal = tmp_path / "consumer.jsonl"
    with ServingFleet(state, 2, max_batch=16, max_latency_ms=1.0, min_bucket=2,
                      journal=journal, device="cpu") as fleet:
        report = portfolio_consumer(fleet, months, x[months], n_quantiles=4)
    with JaxFleet(jstate, 2, max_batch=16, max_latency_ms=1.0, min_bucket=2) as jfleet:
        jreport = jax_consumer(jfleet, months, x[months], n_quantiles=4)
    assert report["shed"] == 0 and report["errors"] == 0 and report["ok"] == report["n"]
    assert replay_journal(journal).clean
    valid = np.isfinite(x[months]).all(axis=-1)
    ex = BucketedExecutor(state, max_batch=64, min_bucket=2, device="cpu")
    want = np.full((months.size, n), np.nan)
    for i, m in enumerate(months):
        rows = np.flatnonzero(valid[i])
        want[i, rows] = ex.run(np.full(rows.size, m), x[m, rows])
    assert np.array_equal(report["quotes"], want, equal_nan=True)
    np.testing.assert_allclose(report["quotes"], jreport["quotes"], rtol=1e-6, atol=1e-7,
                               equal_nan=True)
    for key in ("months_formed", "long_size_mean", "short_size_mean", "turnover_mean",
                "n"):
        assert report[key] == jreport[key], key
    assert np.array_equal(report["long_weights"], jreport["long_weights"])
    assert np.array_equal(report["short_weights"], jreport["short_weights"])
