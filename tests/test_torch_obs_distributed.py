"""The port's distributed observability plane on the CPU, held to
``tests/test_obs_distributed.py``'s contracts, case for case.

- **The wire.** ``trace_env`` carries the router's span context into a
  child's environment and back into the child's root spans; the frame
  header carries ``(t_send_ns, trace_id, parent_span)`` stamps when armed
  and zeros when not; ``record_span`` turns stamp pairs into spans.
- **The aggregator.** Child registry deltas fold under ``{proc=}``
  labels, a departed proc's monotone series fold into
  ``proc="departed"``, and every read and write shares ``SNAPSHOT_LOCK``.
- **The annex.** A double-buffered commit-last shm mailbox whose previous
  mirror survives a SIGKILL between the payload write and the commit
  flip: 30 of 30 rounds on real processes.
- **The timeline.** Per-process exports re-anchor onto the router's clock
  exactly and merge deterministically; ``merge_traces`` and ``analyze``
  give the JAX package's documents and tables on the same trace
  directory; the command line exits 2 without end-to-end coverage.
- **The real fleet.** Both transports produce the same hop chain across
  real replica processes; a replica SIGKILLed at ``shm.ring.commit``
  leaves a harvested flight tail and fleet totals that never move
  backwards, and no segment or doorbell behind.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.parallel.shm import shm_available
from fm_returnprediction_tpu_torch.telemetry import distributed as obs
from fm_returnprediction_tpu_torch.telemetry import regress, spans, timeline

pytestmark = [pytest.mark.torch_port, pytest.mark.obs]

REPO = Path(__file__).resolve().parent.parent
_SHM = pytest.mark.skipif(not shm_available(), reason="POSIX shared memory unavailable here")


@pytest.fixture(autouse=True)
def _clean_plane():
    def clean():
        telemetry.reset()
        telemetry.set_trace_dir(None)
        spans.set_remote_context(None)
        obs.clear_peers()
        obs.reset_delta_state()

    clean()
    yield
    clean()


# -- trace context propagation ----------------------------------------------


def test_trace_env_roundtrips_into_child_root_spans(monkeypatch):
    monkeypatch.delenv("FMRP_TELEMETRY", raising=False)
    monkeypatch.delenv("FMRP_TRACE_DIR", raising=False)
    assert obs.trace_env() == {}
    monkeypatch.setenv("FMRP_TELEMETRY", "1")
    with spans.enabled(True):
        with telemetry.span("router.spawn") as s:
            env = obs.trace_env({"OTHER": "kept"})
        assert env["OTHER"] == "kept" and env["FMRP_TELEMETRY"] == "1"
        assert env["FMRP_TRACE_REMOTE"] == f"{s.trace_id}:{s.span_id}"
        got = obs.install_remote_context_from_env(
            {"FMRP_TRACE_REMOTE": env["FMRP_TRACE_REMOTE"]})
        assert got == (s.trace_id, s.span_id)
        with telemetry.span("child.root") as root:
            with telemetry.span("child.nested") as nested:
                pass
        assert root.attrs["remote_trace"] == s.trace_id
        assert root.attrs["remote_parent"] == s.span_id
        assert "remote_trace" not in nested.attrs
    spans.set_remote_context(None)
    assert obs.install_remote_context_from_env({"FMRP_TRACE_REMOTE": "not-a-context"}) is None


def test_frame_header_carries_trace_stamps_only_when_armed():
    from fm_returnprediction_tpu_torch.serving import shm as fshm

    meta = fshm.frame_meta(fshm.pack_ack([7], [0]))
    assert meta["kind"] == fshm.KIND_ACK and meta["count"] == 1
    assert (meta["t_send_ns"], meta["trace_id"], meta["parent_span"]) == (0, 0, 0)
    with spans.enabled(True):
        with telemetry.span("router.request") as s:
            hot = fshm.pack_ack([7], [0])
    meta = fshm.frame_meta(hot)
    assert meta["t_send_ns"] > 0
    assert (meta["trace_id"], meta["parent_span"]) == (s.trace_id, s.span_id)
    assert fshm.unpack_frame(hot)[0] == fshm.KIND_ACK


def test_record_span_from_explicit_stamps():
    assert spans.record_span("hop.x", 123) is None
    with spans.enabled(True):
        assert spans.record_span("hop.x", 0) is None
        s = spans.record_span("hop.transport_req", 1000, 2000, req=7)
        assert (s.t0_ns, s.t1_ns, s.attrs["req"]) == (1000, 2000, 7)
    assert [x.name for x in spans.finished_spans()] == ["hop.transport_req"]


def test_peer_registry_records_clock_offsets(tmp_path):
    entry = obs.register_peer("r0", pid=123, anchor_ns=spans.EPOCH_ANCHOR_NS + 5000,
                              kind="replica")
    assert entry["offset_ns"] == 5000 and obs.peers()["r0"]["pid"] == 123
    doc = json.loads(obs.dump_peers(tmp_path).read_text())
    assert doc["router_anchor_ns"] == spans.EPOCH_ANCHOR_NS
    assert doc["peers"]["r0"]["offset_ns"] == 5000


# -- metric aggregation ------------------------------------------------------


def test_registry_delta_ships_only_what_moved():
    c = telemetry.registry().counter("fmrp_obstest_deltas_total")
    c.inc(3)
    assert obs.registry_delta()["fmrp_obstest_deltas_total"] == 3
    assert "fmrp_obstest_deltas_total" not in obs.registry_delta()
    c.inc(2)
    assert obs.registry_delta()["fmrp_obstest_deltas_total"] == 5


def test_aggregator_totals_monotone_across_kill_and_respawn():
    agg = obs.MetricAggregator()
    assert agg.ingest("r0", {"fmrp_req_total": 5.0, "fmrp_queue_depth": 3.0,
                             "fmrp_up": True, "bad": float("nan")}) == 3
    agg.ingest("r1", {"fmrp_req_total": 2.0, "fmrp_lat_seconds_sum{bucket=b16}": 0.5})
    assert agg.procs() == ("r0", "r1")
    snap = agg.snapshot()
    assert snap["fmrp_req_total{proc=r0}"] == 5.0
    assert snap["fmrp_lat_seconds_sum{bucket=b16,proc=r1}"] == 0.5
    before = agg.totals()
    assert before["fmrp_req_total"] == 7.0
    agg.fold_dead("r0")
    snap = agg.snapshot()
    assert "fmrp_req_total{proc=r0}" not in snap and "fmrp_queue_depth{proc=r0}" not in snap
    assert snap["fmrp_req_total{proc=departed}"] == 5.0
    assert agg.totals()["fmrp_req_total"] == 7.0
    agg.ingest("r2", {"fmrp_req_total": 1.0})
    after = agg.totals()
    assert all(after[k] >= v for k, v in before.items())
    assert after["fmrp_req_total"] == 8.0
    agg.fold_dead("r0")
    agg.fold_dead("never-lived")
    assert agg.totals()["fmrp_req_total"] == 8.0
    text = agg.prometheus_text()
    assert 'fmrp_req_total{proc="departed"} 5.0' in text
    assert 'fmrp_lat_seconds_sum{bucket="b16",proc="r1"} 0.5' in text
    assert "# TYPE" not in text


def test_scrape_and_ingest_serialize_on_the_snapshot_lock():
    from fm_returnprediction_tpu_torch.telemetry import metrics as _metrics

    agg = obs.MetricAggregator()
    agg.ingest("r0", {"fmrp_req_total": 1.0})
    done = threading.Event()
    with _metrics.SNAPSHOT_LOCK:
        t = threading.Thread(target=lambda: (agg.ingest("r0", {"fmrp_req_total": 2.0}),
                                             done.set()))
        t.start()
        time.sleep(0.1)
        assert not done.is_set()
        assert agg.snapshot()["fmrp_req_total{proc=r0}"] == 1.0
    t.join(timeout=5)
    assert done.is_set() and agg.snapshot()["fmrp_req_total{proc=r0}"] == 2.0


def test_build_info_gauge_in_exposition():
    """The port's build-info labels name torch, CUDA and the device where
    the reference's name jax and its backend."""
    text = telemetry.prometheus_text()
    (line,) = [ln for ln in text.splitlines() if ln.startswith("fmrp_build_info{")]
    assert line.endswith(" 1")
    assert f'torch="{torch.__version__}"' in line and 'device="' in line
    assert "# TYPE fmrp_build_info gauge" in text


# -- flight annex ------------------------------------------------------------


@_SHM
def test_annex_mirror_harvest_roundtrip():
    annex = obs.FlightAnnex.create("t-roundtrip", nbytes=2048)
    try:
        assert annex.harvest() is None
        assert annex.mirror({"type": "flight", "n": 1})
        assert annex.harvest() == {"type": "flight", "n": 1}
        assert annex.mirror({"type": "flight", "n": 2})
        assert annex.harvest() == {"type": "flight", "n": 2}
        assert not annex.mirror({"blob": "x" * 4096})
        assert annex.harvest() == {"type": "flight", "n": 2}
        assert annex.mirror_flight("test", max_spans=4)
        got = annex.harvest()
        assert got["type"] == "flight" and got["reason"] == "test"
    finally:
        annex.release()


_ANNEX_CHILD = r"""
import json, sys
from fm_returnprediction_tpu_torch.resilience.faults import FaultPlan, FaultSpec
from fm_returnprediction_tpu_torch.telemetry.distributed import ANNEX_MIRROR_SITE, FlightAnnex

for spec in json.loads(sys.argv[1]):
    annex = FlightAnnex.attach(spec)
    assert annex.mirror({"type": "flight", "round": spec["round"], "payload": "survivor"})
    if spec.get("last"):
        # SIGKILL exactly between the next mirror's payload write and its
        # commit flip: the torn write must read as absent
        FaultPlan({ANNEX_MIRROR_SITE: FaultSpec(times=1, sigkill=True)}).__enter__()
    annex.mirror({"type": "flight", "round": spec["round"], "payload": "torn"
                  if spec.get("last") else "second"})
    annex.close()
sys.exit(3)
"""


@_SHM
def test_annex_survives_sigkill_midwrite_30x():
    """30/30: a child SIGKILLed at ``obs.annex_mirror``, after the new
    payload is down but before the active-slot flip, leaves the previous
    mirror harvestable, never a torn one. Each round is its own process
    (its own budget of 60 s)."""
    for i in range(30):
        annex = obs.FlightAnnex.create(f"chaos{i}", nbytes=2048)
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _ANNEX_CHILD,
                 json.dumps([{**annex.describe(), "round": i, "last": True}])],
                capture_output=True, text=True, timeout=60,
                env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
            assert proc.returncode == -signal.SIGKILL, (i, proc.returncode, proc.stderr)
            assert annex.harvest() == {"type": "flight", "round": i, "payload": "survivor"}, i
        finally:
            annex.release()


# -- timeline merge + per-hop attribution ------------------------------------


def _write_export(path, anchor_ns, pid, proc_index, span_rows):
    meta = {"type": "meta", "schema": 1, "pid": pid, "anchor_ns": anchor_ns,
            "spans": len(span_rows), "events": 0, "dropped": 0}
    if proc_index is not None:
        meta["process_index"] = proc_index
    recs = [meta]
    for n, (name, ts_us, dur_us) in enumerate(span_rows, start=1):
        recs.append({"type": "span", "name": name, "cat": "hop", "ts_us": ts_us,
                     "dur_us": dur_us, "trace_id": 1, "span_id": n, "parent_id": None,
                     "thread_id": 1, "thread_name": "main", "attrs": {}})
    path.write_text("\n".join(json.dumps(r, sort_keys=True) for r in recs) + "\n")


def test_merge_realigns_child_clocks_exactly_and_deterministically(tmp_path):
    from fm_returnprediction_tpu.telemetry import timeline as jax_timeline

    a_router, a_child = 2_000_000_000, 1_500_000_000
    _write_export(tmp_path / "events.jsonl", a_router, 100, None,
                  [("fleet.request", 1000.0, 10_000.0), ("hop.admit", 1000.0, 2_000.0),
                   ("hop.complete", 9000.0, 1_000.0)])
    _write_export(tmp_path / "events.p0.jsonl", a_child, 200, 0,
                  [("hop.solve", 500.0, 5_000.0)])
    path, doc = timeline.merge_traces(tmp_path)
    assert path == tmp_path / "timeline.json"
    rows = {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert rows == {"fmrp-router", "fmrp-child[p0]"}
    solve = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == "hop.solve"]
    assert solve[0]["ts"] == 500.0 + (a_router - a_child) / 1e3
    admit = [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == "hop.admit"]
    assert admit[0]["ts"] == 1000.0
    first = path.read_bytes()
    timeline.merge_traces(tmp_path)
    assert path.read_bytes() == first
    # the reference merges the same directory into the same document
    jpath, jdoc = jax_timeline.merge_traces(tmp_path, out_name="timeline_jax.json")
    assert jdoc == doc and jpath.read_bytes() == first


def test_analyze_attributes_hop_shares_and_router_ceiling(tmp_path, capsys):
    from fm_returnprediction_tpu.telemetry import timeline as jax_timeline

    _write_export(tmp_path / "events.jsonl", 0, 100, None,
                  [("fleet.request", 0.0, 10_000.0), ("hop.admit", 0.0, 2_000.0),
                   ("hop.complete", 0.0, 1_000.0)])
    _write_export(tmp_path / "events.p0.jsonl", 0, 200, 0, [("hop.solve", 0.0, 5_000.0)])
    journal = tmp_path / "journal.jsonl"
    journal.write_text(json.dumps({"ev": "admit", "req": 1, "seq": 1}) + "\n"
                       + json.dumps({"ev": "done", "req": 1, "seq": 2}) + "\n")
    report = timeline.analyze(tmp_path, journal_path=journal)
    assert report["processes"] == 2 and report["requests"] == 1
    assert report["e2e_p50_ms"] == 10.0
    assert report["hops"]["hop.solve"]["share_pct"] == 50.0
    assert report["attributed_pct"] == 80.0 and report["router_share_pct"] == 30.0
    assert report["journal"] == {"admit": 1, "done": 1}
    table = timeline.format_table(report)
    assert "hop.solve" in table and "router hops 30.0%" in table
    assert report == jax_timeline.analyze(tmp_path, journal_path=journal)
    assert table == jax_timeline.format_table(report)
    assert timeline.main(["-", str(tmp_path)]) == 0
    empty = tmp_path / "empty"
    empty.mkdir()
    assert timeline.main(["-", str(empty)]) == 2
    out = subprocess.run([sys.executable, "-m", "fm_returnprediction_tpu_torch.telemetry.timeline",
                          str(journal), str(tmp_path)], capture_output=True, text=True,
                         timeout=60, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and "router hops 30.0%" in out.stdout, out.stderr


# -- journal timestamps (opt-in) ---------------------------------------------


def test_journal_t_ns_is_opt_in(tmp_path, monkeypatch):
    from fm_returnprediction_tpu_torch.serving.journal import RequestJournal

    monkeypatch.delenv("FMRP_OBS_JOURNAL_TS", raising=False)
    with RequestJournal(tmp_path / "off.jsonl") as j:
        j.append("admit", 1)
        j.append("done", 1)
    recs = [json.loads(ln) for ln in (tmp_path / "off.jsonl").read_text().splitlines()]
    assert all("t_ns" not in r for r in recs)
    monkeypatch.setenv("FMRP_OBS_JOURNAL_TS", "1")
    with RequestJournal(tmp_path / "on.jsonl") as j:
        j.append("admit", 1)
    (rec,) = [json.loads(ln) for ln in (tmp_path / "on.jsonl").read_text().splitlines()]
    assert isinstance(rec["t_ns"], int) and rec["t_ns"] > 0


# -- regress: disabled-section disclosure ------------------------------------


def test_regress_disabled_sections_skip_not_missing(tmp_path):
    why = "FMRP_BENCH_FLEET=0 (deliberately disabled this round)"
    r1 = {"metric": "wall_s", "value": 10.0,
          "extra": {"fleet_p50_ms": 1.2, "other_p50_ms": 2.0, "device": "cpu"}}
    r2 = {"metric": "wall_s", "value": 10.0,
          "extra": {"fleet": {"disabled": why}, "device": "cpu"}}
    p1, p2 = tmp_path / "BENCH_r01.json", tmp_path / "BENCH_r02.json"
    p1.write_text(json.dumps({"n": 1, "parsed": r1}))
    p2.write_text(json.dumps({"n": 2, "parsed": r2}))
    rounds = regress.load_rounds([p1, p2])
    assert rounds[-1].disabled == {"fleet": why}
    report = regress.analyze(rounds)
    verdicts = {v.key.split("@", 1)[0]: v for v in report.verdicts}
    assert verdicts["fleet_p50_ms"].status == "skipped" and why in verdicts["fleet_p50_ms"].note
    assert verdicts["other_p50_ms"].status == "missing"
    assert dict(report.disabled) == {"fleet": why}
    assert report.to_json()["disabled"] == {"fleet": why}
    text = report.format_text()
    assert why in text and "never gated" in text


# -- the real fleet: parity, harvest, monotone scrape -------------------------


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


def _await_exports(trace_dir, n, budget_s=20.0):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if len(list(trace_dir.glob("events*.jsonl"))) >= n:
            return
        time.sleep(0.1)
    pytest.fail(f"never saw {n} exports in {trace_dir}: "
                f"{sorted(p.name for p in trace_dir.glob('*'))}")


@_SHM
def test_span_propagation_parity_shm_vs_socket(tmp_path, monkeypatch):
    """Both transports produce the same hop chain across real replica
    processes: router hops in the router's export, child hops in the
    children's, child root spans carrying the router's remote context."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet

    rng = np.random.default_rng(11)
    state, months = _tiny_state(rng)
    qx = rng.standard_normal(4).astype(np.float32)
    seen = {}
    for transport in ("shm", "socket"):
        trace_dir = tmp_path / f"trace-{transport}"
        monkeypatch.setenv("FMRP_TELEMETRY", "1")
        monkeypatch.setenv("FMRP_TRACE_DIR", str(trace_dir))
        journal = tmp_path / f"journal-{transport}.jsonl"
        with telemetry.tracing(str(trace_dir)):
            with telemetry.span("fleet.spawn", transport=transport):
                fleet = ServingFleet(state, 2, replica_mode="process", transport=transport,
                                     journal=str(journal), max_batch=16, max_latency_ms=1.0,
                                     device="cpu")
            try:
                vals = [f.result(timeout=60)
                        for f in [fleet.submit(int(months[0]), qx) for _ in range(16)]]
                assert len(set(vals)) == 1 and np.isfinite(vals[0])
            finally:
                fleet.close()
        _await_exports(trace_dir, 3)
        procs = timeline.load_process_traces(trace_dir)
        children = [p for p in procs if p["meta"].get("process_index") is not None]
        assert len(children) == 2, [p["path"] for p in procs]
        by_side = {"router": set(), "child": set()}
        for p in procs:
            side = "child" if p in children else "router"
            by_side[side] |= {r["name"] for r in p["records"] if r.get("type") == "span"}
        wanted = set(timeline.HOPS) | {timeline.E2E_SPAN}
        seen[transport] = {side: names & wanted for side, names in by_side.items()}
        assert any((r.get("attrs") or {}).get("remote_trace")
                   for p in children for r in p["records"] if r.get("type") == "span")
        report = timeline.analyze(trace_dir, journal_path=journal)
        assert report["requests"] >= 16 and report["attributed_pct"] > 0
        telemetry.reset()
    assert seen["shm"] == seen["socket"], seen
    assert timeline.E2E_SPAN in seen["shm"]["router"]
    assert "hop.admit" in seen["shm"]["router"] and "hop.solve" in seen["shm"]["child"]


@_SHM
@pytest.mark.parametrize("transport,site", [("shm", "shm.ring.commit"),
                                            ("socket", "replica.result_send")])
def test_chaos_sigkill_flight_harvest_and_monotone_scrape(transport, site, tmp_path,
                                                          monkeypatch):
    """A replica SIGKILLed mid-result-send (``shm.ring.commit`` between a
    result frame's payload and its commit word, or ``replica.result_send``
    on the socket): the supervisor's heartbeat finds it and fails it over, its flight annex
    harvests through the kill into ``fleet.flights``, the fleet's metric
    totals never move backwards across the kill and respawn, the scrape
    carries the ``proc="departed"`` fold, and closing leaves no segment
    and no doorbell behind. (The reference drives the repair through its
    topology controller, ROADMAP item 9; the fleet's own supervisor does
    it here.)"""
    from fm_returnprediction_tpu_torch.parallel import shm as pshm
    from fm_returnprediction_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from fm_returnprediction_tpu_torch.serving import ServingFleet, replay_journal
    from fm_returnprediction_tpu_torch.serving import shm as fshm

    monkeypatch.setenv("FMRP_OBS_ANNEX", "1")
    rng = np.random.default_rng(13)
    state, months = _tiny_state(rng)
    journal = tmp_path / "journal.jsonl"
    segs0, bells0 = pshm.owned_segments(), fshm.open_doorbells()
    with FaultPlan({site: FaultSpec(times=1, sigkill=True, proc="0")}):
        fleet = ServingFleet(state, 2, replica_mode="process", transport=transport,
                             journal=str(journal), max_batch=16, max_latency_ms=2.0,
                             device="cpu")
    try:
        victim = "r0"
        victim_proc = fleet.replica(victim).service.proc
        # prime the aggregator: a stats probe (over the socket, not the
        # ring) ships each child's first, full registry delta
        for rid in list(fleet.replica_states()):
            fleet.replica(rid).service.stats()
        qx = rng.standard_normal(4).astype(np.float32)
        futs = [fleet.submit(int(months[0]), qx) for _ in range(8)]
        vals = [f.result(timeout=60) for f in futs]
        assert len(set(vals)) == 1 and np.isfinite(vals[0])
        victim_proc.wait(timeout=30)
        assert victim_proc.returncode == -signal.SIGKILL
        before = fleet.aggregator.totals()
        deadline = time.monotonic() + 60
        while victim in fleet.replica_states() and time.monotonic() < deadline:
            fleet.supervisor.tick()
            time.sleep(0.05)
        assert victim not in fleet.replica_states()
        flight = fleet.flights.get(victim)
        assert flight is not None and flight["type"] == "flight"
        for rid in list(fleet.replica_states()):
            fleet.replica(rid).service.stats()
        after = fleet.aggregator.totals()
        for key, val in before.items():
            assert after.get(key, 0.0) >= val - 1e-9, (key, val)
        text = fleet.prometheus_metrics()
        assert "fmrp_build_info{" in text and 'proc="departed"' in text
        assert fleet.stats()["healthy_replicas"] == 2
    finally:
        fleet.close()
    assert replay_journal(journal).clean
    assert pshm.owned_segments() == segs0 and fshm.open_doorbells() == bells0
