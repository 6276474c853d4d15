"""The port's telemetry layer vs ``tests/test_telemetry.py`` and the JAX
package's telemetry, on the CPU.

- Off is a no-op (one shared no-op context manager); spans nest, carry
  ids, propagate across threads only through ``capture``/``attach``, and
  record exceptions.
- The metrics registry: private counters aggregate and survive GC, shared
  counters are one instrument per label set, histograms render
  cumulatively, and the Prometheus text of the same scripted instruments
  is byte-equal to the JAX registry's (``fmrp_build_info`` and the cache
  gauges aside: the port's is the nvcc build cache, the reference's the
  XLA compilation cache).
- The JSONL log and the Chrome trace of the same scripted spans have the
  JAX exports' record types, keys and order, and re-export byte-equal.
- Hooks: retry events against a ``FaultPlan`` (the same events as the JAX
  package's), checkpoint hit/miss/save events and counters, guard
  sentinel trips in ``fmrp_guard_sentinel_total``, the spec-grid sweep's
  spans and cell counter, stage spans under ``run_pipeline``, the serving
  request → batch → dispatch chain, the metrics endpoint.
- ``run_pipeline(device="cpu", trace_dir=)`` writes both trace files with
  the stage spans, and a traced run's artifacts are sha256-equal to an
  untraced run's (and its kernel launch counters equal: all zero here,
  where the plain versions run).
- Process identity: precedence, and labels only when armed.
"""

import hashlib
import json
import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu import telemetry as jax_telemetry
from fm_returnprediction_tpu.telemetry import export as jax_export
from fm_returnprediction_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig
from fm_returnprediction_tpu_torch.ops.rolling import (
    masked_cumulative_moments_cuda,
    rolling_reduce_cuda,
)
from fm_returnprediction_tpu_torch.pipeline import run_pipeline
from fm_returnprediction_tpu_torch.specgrid.grams import gram_contract_cuda
from fm_returnprediction_tpu_torch.telemetry import export, identity
from fm_returnprediction_tpu_torch.telemetry.metrics import MetricsRegistry

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("FMRP_PROC_INDEX", raising=False)
    monkeypatch.delenv("FMRP_DIST_PROC_ID", raising=False)
    for tel in (telemetry, jax_telemetry):
        tel.reset()
        tel.set_trace_dir(None)
        tel.cost_ledger().reset()  # program records of earlier tests in the process
    yield
    for tel in (telemetry, jax_telemetry):
        tel.reset()
        tel.set_trace_dir(None)


def _data(t=10, n=24, p=3, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    y = x @ (rng.standard_normal(p) * 0.05) + 0.1 * rng.standard_normal((t, n))
    mask = rng.random((t, n)) > 0.2
    return np.where(mask, y, np.nan), x, mask


# -- span mechanics ---------------------------------------------------------


def test_off_mode_span_is_shared_noop():
    assert not telemetry.active()
    cm1, cm2 = telemetry.span("a"), telemetry.span("b", x=1)
    assert cm1 is cm2
    with cm1 as s:
        assert s is None
    assert telemetry.finished_spans() == []
    telemetry.event("ignored", k=1)
    assert telemetry.standalone_events() == []
    assert telemetry.capture() is None


def test_span_nesting_and_ids():
    with telemetry.enabled(True):
        with telemetry.span("root", cat="stage") as root:
            telemetry.event("marker", k=1)
            with telemetry.span("child") as child:
                with telemetry.span("grandchild") as grand:
                    pass
        with telemetry.span("second_root") as r2:
            pass
    assert child.parent_id == root.span_id and grand.parent_id == child.span_id
    assert child.trace_id == root.trace_id == root.span_id
    assert r2.parent_id is None and r2.trace_id != root.trace_id
    assert [e[0] for e in root.events] == ["marker"]
    assert telemetry.standalone_events() == []
    assert [s.name for s in telemetry.finished_spans()] == \
        ["grandchild", "child", "root", "second_root"]
    assert all(s.t1_ns >= s.t0_ns for s in telemetry.finished_spans())


def test_span_propagates_across_threads_via_attach():
    got = {}
    with telemetry.enabled(True):
        with telemetry.span("parent") as parent:
            handoff = telemetry.capture()

            def worker():
                got["ambient"] = telemetry.current_span()
                with telemetry.attach(handoff):
                    with telemetry.span("worker-span"):
                        pass

            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
    assert got["ambient"] is None
    (ws,) = [s for s in telemetry.finished_spans() if s.name == "worker-span"]
    assert ws.parent_id == parent.span_id and ws.trace_id == parent.trace_id
    assert ws.thread_id != parent.thread_id


def test_span_records_exception_and_still_raises():
    with telemetry.enabled(True):
        with pytest.raises(ValueError):
            with telemetry.span("boom"):
                raise ValueError("pow")
    (s,) = telemetry.finished_spans()
    assert "pow" in s.attrs["error"]


def test_timed_box_and_device_sync_events(monkeypatch):
    with telemetry.enabled(True):
        with telemetry.span("stage"):
            with telemetry.timed("block", k=2) as box:
                pass
            telemetry.device_sync([torch.zeros(2)])
            monkeypatch.setenv("FMRP_SYNC_STAGES", "1")
            telemetry.device_sync({"a": torch.zeros(2), "b": [torch.ones(1)]})
    assert box.s >= 0
    (stage,) = [s for s in telemetry.finished_spans() if s.name == "stage"]
    syncs = [e[2] for e in stage.events if e[0] == "device_sync"]
    assert [e["synced"] for e in syncs] == [False, True] and "wait_ms" in syncs[1]
    assert any(s.name == "block" and s.cat == "timer" for s in telemetry.finished_spans())


# -- metrics registry -------------------------------------------------------


def test_private_counters_aggregate_and_survive_gc():
    reg = telemetry.registry()
    name = "fmrp_test_obs_agg_total"
    base = reg.collect().get(name, {}).get((), 0)
    c1, c2 = reg.private_counter(name), reg.private_counter(name)
    c1.inc(3)
    c2.inc(4)
    assert (c1.value, c2.value) == (3, 4)
    assert reg.collect()[name][()] - base == 7
    del c1
    assert reg.collect()[name][()] - base == 7


def test_shared_counter_identity_and_labels():
    reg = telemetry.registry()
    a = reg.counter("fmrp_test_obs_shared_total", site="a")
    b = reg.counter("fmrp_test_obs_shared_total", site="b")
    assert reg.counter("fmrp_test_obs_shared_total", site="a") is a and a is not b
    a.inc(2)
    text = reg.to_prometheus()
    assert 'fmrp_test_obs_shared_total{site="a"} 2' in text
    assert "# TYPE fmrp_test_obs_shared_total counter" in text
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("fmrp_test_obs_shared_total")


def test_histogram_prometheus_rendering():
    reg = telemetry.registry()
    h = reg.private_histogram("fmrp_test_obs_lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(5.555)
    text = reg.to_prometheus()
    assert 'fmrp_test_obs_lat_seconds_bucket{le="0.01"} 1' in text
    assert 'fmrp_test_obs_lat_seconds_bucket{le="+Inf"} 4' in text
    assert "fmrp_test_obs_lat_seconds_count 4" in text


def _scripted(reg):
    reg.counter("fmrp_test_a_total", help="a counter", site="x").inc(3)
    reg.counter("fmrp_test_a_total", help="a counter", site="y").inc()
    kept = reg.private_counter("fmrp_test_private_total", help="private")
    kept.inc(5)
    gone = reg.private_counter("fmrp_test_private_total", help="private")
    gone.inc(2)
    del gone
    reg.gauge("fmrp_test_gauge", help="gauge\nwith a newline", route='say "hi"').set(1.5)
    hist = reg.private_histogram("fmrp_test_lat_seconds", help="latency",
                                 buckets=(0.001, 0.01, 0.1), replica="r0")
    for v in (0.0005, 0.02, 0.5, 0.05):
        hist.observe(v)
    reg.histogram("fmrp_test_occupancy", buckets=(0.25, 0.5, 1.0)).observe(0.5)
    reg.counter("fmrp_test_escape_total", detail='a\\b\nc"d').inc()
    return kept, hist


def _without_cache_gauges(text):
    return "\n".join(line for line in text.splitlines()
                     if "_cache_entries" not in line and "_cache_bytes" not in line)


def test_prometheus_text_is_byte_equal_to_the_jax_registry():
    port, ref = MetricsRegistry(), JaxRegistry()
    keep_port = _scripted(port)
    keep_ref = _scripted(ref)
    text_port, text_ref = port.to_prometheus(), ref.to_prometheus()
    assert _without_cache_gauges(text_port) == _without_cache_gauges(text_ref)
    assert "fmrp_cuda_build_cache_entries" in text_port
    assert "fmrp_jax_compile_cache_entries" in text_ref
    assert keep_port[0].value == keep_ref[0].value == 5


def test_cuda_build_cache_stats_counts_files_only(tmp_path):
    (tmp_path / "librolling_0123.so").write_bytes(b"x" * 10)
    (tmp_path / "libgram_4567.so").write_bytes(b"y" * 5)
    (tmp_path / "subdir").mkdir()
    assert telemetry.cuda_build_cache_stats(str(tmp_path)) == {"entries": 2, "bytes": 15}
    assert telemetry.cuda_build_cache_stats(str(tmp_path / "missing")) == \
        {"entries": 0, "bytes": 0}


def test_cuda_build_cache_gauges_read_the_build_dir(monkeypatch, tmp_path):
    from fm_returnprediction_tpu_torch import cuda_build

    (tmp_path / "librolling_89ab.so").write_bytes(b"z" * 7)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    collected = MetricsRegistry().collect()
    assert collected["fmrp_cuda_build_cache_entries"][()] == 1
    assert collected["fmrp_cuda_build_cache_bytes"][()] == 7


# -- exporters --------------------------------------------------------------


def _make_some_spans(tel):
    with tel.enabled(True):
        with tel.span("alpha", cat="stage", idx=1):
            tel.event("tick", n=1)
            with tel.span("beta"):
                pass
        tel.event("orphan", cat="loose", z="q")


def _shape(records):
    out = []
    for r in records:
        if r["type"] == "metrics":
            out.append(("metrics",))
            continue
        keys = tuple(sorted(r))
        events = r["events"] if r["type"] == "span" else ()
        out.append((r["type"], r.get("name"), keys, tuple(tuple(sorted(e)) for e in events)))
    return out


def test_jsonl_schema_matches_the_jax_export(tmp_path):
    _make_some_spans(telemetry)
    _make_some_spans(jax_telemetry)
    p1, p2 = export.write_jsonl(tmp_path / "a.jsonl"), export.write_jsonl(tmp_path / "b.jsonl")
    assert p1.read_bytes() == p2.read_bytes()
    ref = jax_export.write_jsonl(tmp_path / "jax.jsonl")
    records = [json.loads(line) for line in p1.read_text().splitlines()]
    ref_records = [json.loads(line) for line in ref.read_text().splitlines()]
    assert _shape(records) == _shape(ref_records)
    spans = [r for r in records if r["type"] == "span"]
    assert [s["name"] for s in spans] == ["alpha", "beta"]
    assert spans[1]["parent_id"] == spans[0]["span_id"]
    assert spans[0]["events"][0]["name"] == "tick"
    assert records[0]["type"] == "meta" and records[-1]["type"] == "metrics"


def test_chrome_trace_matches_the_jax_export(tmp_path):
    _make_some_spans(telemetry)
    _make_some_spans(jax_telemetry)
    doc = json.loads(export.write_chrome_trace(tmp_path / "trace.json").read_text())
    ref = json.loads(jax_export.write_chrome_trace(tmp_path / "jax.json").read_text())
    assert sorted(doc) == sorted(ref) and sorted(doc["otherData"]) == sorted(ref["otherData"])

    def shape(events):
        return [(e["ph"], e["name"], tuple(sorted(e))) for e in events
                if not e["name"].startswith("compile:") and e["ph"] != "C"
                and e.get("tid") != 999_999]

    assert shape(doc["traceEvents"]) == shape(ref["traceEvents"])
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in complete} == {"alpha", "beta"}
    assert all(e["dur"] >= 0 for e in complete)


def test_flush_writes_both_files_to_trace_dir(tmp_path):
    _make_some_spans(telemetry)
    telemetry.set_trace_dir(tmp_path)
    jsonl, chrome = telemetry.flush()
    assert jsonl.exists() and chrome.exists()
    telemetry.set_trace_dir(None)
    assert telemetry.flush() is None


def test_tracing_context_restores_the_previous_state(tmp_path):
    with telemetry.tracing(None):
        assert not telemetry.active()  # a pass-through when nothing is armed
    with telemetry.tracing(tmp_path):
        assert telemetry.active() and telemetry.trace_dir() == str(tmp_path)
        with telemetry.span("inside"):
            pass
    assert not telemetry.active() and telemetry.trace_dir() is None
    assert (tmp_path / "events.jsonl").exists() and (tmp_path / "trace.json").exists()


# -- integrations -----------------------------------------------------------


def _retry_trace(tel, faults, retry):
    with tel.enabled(True):
        with faults.FaultPlan({"obs.flaky": faults.FaultSpec(times=2)}) as plan:
            with tel.span("carrier"):
                retry.call_with_retry(lambda: faults.fault_site("obs.flaky") or True,
                                      retry.RetryPolicy(max_attempts=4, backoff_s=0.01),
                                      label="obs.flaky", sleep=lambda s: None)
    (carrier,) = [s for s in tel.finished_spans() if s.name == "carrier"]
    attempts = [s.attrs["attempt"] for s in tel.finished_spans()
                if s.name == "retry:obs.flaky"]
    return [(e[0], sorted(e[2])) for e in carrier.events], attempts, plan.fired["obs.flaky"]


def test_retry_events_match_fault_plan_and_the_jax_package():
    from fm_returnprediction_tpu.resilience import faults as jax_faults
    from fm_returnprediction_tpu.resilience import retry as jax_retry
    from fm_returnprediction_tpu_torch.resilience import faults, retry

    events, attempts, fired = _retry_trace(telemetry, faults, retry)
    assert [name for name, _ in events].count("retry.attempt") == fired == 2
    assert [name for name, _ in events].count("retry.backoff") == 2
    assert attempts == [1, 2, 3]
    assert (events, attempts, fired) == _retry_trace(jax_telemetry, jax_faults, jax_retry)
    policy = retry.RetryPolicy(max_attempts=5, seed=3)
    ref = jax_retry.RetryPolicy(max_attempts=5, seed=3)
    assert [policy.delay_s(k, "x") for k in range(1, 5)] == [ref.delay_s(k, "x")
                                                             for k in range(1, 5)]


def test_retry_exhausted_counts_and_raises():
    from fm_returnprediction_tpu_torch.resilience.errors import RetryExhaustedError
    from fm_returnprediction_tpu_torch.resilience.retry import RetryPolicy, retrying

    counter = telemetry.registry().counter("fmrp_retry_exhausted_total")
    before = counter.value

    @retrying(RetryPolicy(max_attempts=2, backoff_s=0.0), sleep=lambda s: None)
    def always_fails():
        raise OSError("down")

    with pytest.raises(RetryExhaustedError) as exc:
        always_fails()
    assert isinstance(exc.value.__cause__, OSError)
    assert counter.value == before + 1


def test_checkpoint_hit_miss_events_and_counters(tmp_path):
    from fm_returnprediction_tpu_torch.resilience.checkpoint import (
        OUTCOMES,
        StageCheckpointer,
    )

    family = lambda: telemetry.registry().collect()["fmrp_checkpoint_total"]  # noqa: E731
    ck = StageCheckpointer(tmp_path, "fp")
    before = dict(OUTCOMES)
    with telemetry.enabled(True):
        ck.frame("t", lambda: pd.DataFrame({"a": [1.0]}))
        metrics_before_hit = dict(family())
        StageCheckpointer(tmp_path, "fp").frame("t", lambda: pytest.fail("must load"))
    events = [e["name"] for e in telemetry.standalone_events()]
    assert events == ["checkpoint.miss", "checkpoint.save", "checkpoint.hit"]
    assert {k: OUTCOMES[k] - before.get(k, 0) for k in ("miss", "save", "hit")} == \
        {"miss": 1, "save": 1, "hit": 1}
    assert family()[(("outcome", "hit"),)] == metrics_before_hit.get((("outcome", "hit"),), 0) + 1


def test_guard_sentinel_trips_mirror_into_the_registry():
    from fm_returnprediction_tpu_torch.guard import checks

    key = "obs.probe.bad_months"
    counter = telemetry.registry().counter("fmrp_guard_sentinel_total", sentinel=key)
    before, audit_before = counter.value, checks.counters().get(key, 0)
    with telemetry.enabled(True):
        checks.record("obs.probe", {"bad_months": torch.tensor(3), "fine": 0})
        drained = checks.drain()
    assert drained[key] - audit_before == 3
    assert counter.value - before == 3
    assert ("guard.sentinel", {"sentinel": key, "count": 3}) in [
        (e["name"], e["attrs"]) for e in telemetry.standalone_events()]


def test_specgrid_sweep_spans_and_cells_counter():
    from fm_returnprediction_tpu_torch.specgrid.cellspace import CellSpace
    from fm_returnprediction_tpu_torch.specgrid.engine import run_cellspace

    y, x, mask = _data(t=36, n=40)
    space = CellSpace(regressor_sets=(("m1", ("c0", "c1")), ("m2", ("c0", "c1", "c2"))),
                      universes=("All",), windows=(("full", None),))
    cells = telemetry.registry().counter("fmrp_specgrid_cells_total")
    before = cells.value
    with telemetry.enabled(True):
        frame, stats = run_cellspace(torch.tensor(y), torch.tensor(x),
                                     {"All": torch.tensor(mask)}, space, tile_cells=1,
                                     mask=torch.tensor(mask))
    assert cells.value - before == len(space) == stats["cells"]
    spans = telemetry.finished_spans()
    (sweep,) = [s for s in spans if s.name == "specgrid.cellspace"]
    tiles = [s for s in spans if s.name == "specgrid.tile"]
    assert len(tiles) == stats["tiles"] == len(space)
    assert all(t.parent_id == sweep.span_id for t in tiles)
    assert stats["seconds"] == pytest.approx(sweep.duration_s, abs=0.05)


def _serving_state(t=24, n=40, p=4, seed=5):
    from fm_returnprediction_tpu_torch.serving import build_serving_state

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p)).astype(np.float32)
    y = (0.1 * rng.standard_normal((t, n))).astype(np.float32)
    mask = rng.random((t, n)) > 0.2
    y = np.where(mask, y, np.nan).astype(np.float32)
    return build_serving_state(torch.tensor(y), torch.tensor(x), torch.tensor(mask),
                               window=12, min_periods=6), x


def test_serving_stats_shape_unchanged_and_spans_emitted():
    from fm_returnprediction_tpu_torch.serving import ERService

    state, x = _serving_state()
    t = state.n_months
    with ERService(state, max_batch=8, auto_flush=False, device="cpu") as svc:
        with telemetry.enabled(False):
            svc.submit(t - 1, x[t - 1, 0])
            svc.batcher.drain()
        off_stats = svc.stats()
    with telemetry.enabled(True):
        with ERService(state, max_batch=8, auto_flush=False, device="cpu") as svc:
            svc.submit(t - 1, x[t - 1, 0])
            svc.batcher.drain()
            on_stats = svc.stats()
    assert set(off_stats) == set(on_stats)
    for k in off_stats:
        assert type(off_stats[k]) is type(on_stats[k]), k
    (batch,) = [s for s in telemetry.finished_spans() if s.name == "serving.batch"]
    (dispatch,) = [s for s in telemetry.finished_spans() if s.name == "serving.dispatch"]
    assert dispatch.parent_id == batch.span_id
    assert dispatch.attrs == {"bucket": 1, "rows": 1}
    compiles = [s for s in telemetry.finished_spans() if s.name == "serving.compile"]
    assert sorted(s.attrs["bucket"] for s in compiles) == [1, 2, 4, 8]
    assert any(e["name"] == "serving.submit" for e in telemetry.standalone_events())


def test_erservice_prometheus_endpoint_hook():
    from fm_returnprediction_tpu_torch.serving import ERService

    state, x = _serving_state(seed=6)
    t = state.n_months
    with ERService(state, max_batch=8, auto_flush=False, device="cpu") as svc:
        svc.submit(t - 1, x[t - 1, 0])
        svc.batcher.drain()
        text = svc.prometheus_metrics()
    assert "fmrp_serving_executable_cache_hits_total" in text
    assert "fmrp_serving_requests_done_total" in text
    assert "fmrp_serving_service_n_done 1" in text
    assert "fmrp_serving_service_degraded 0" in text
    assert "fmrp_serving_service_quarantined_months" not in text
    assert 'fmrp_build_info{code_salt="' in text and f'torch="{torch.__version__}"' in text


def _artifact_digests(out_dir: Path) -> dict:
    """sha256 of every artifact file (the marker only stamps the time)."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(out_dir.iterdir())
            if p.is_file() and p.name != "data_saved.marker"}


def _counters():
    return (rolling_reduce_cuda.launches, gram_contract_cuda.launches,
            masked_cumulative_moments_cuda.launches)


RUN = dict(synthetic=True, synthetic_config=SyntheticConfig(n_firms=30, n_months=72),
           device="cpu", dtype=torch.float64, make_figure=False, compile_pdf=False)


def test_pipeline_trace_dir_end_to_end(tmp_path):
    """``run_pipeline(trace_dir=)`` and a few service queries: one JSONL log
    and one Chrome trace with the run root, the stage spans (parented to
    it, one trace) and the serving dispatches; every stage of
    ``timer.durations`` has its span."""
    from fm_returnprediction_tpu_torch.serving import ERService

    trace_dir = tmp_path / "traces"
    res = run_pipeline(**RUN, trace_dir=trace_dir)
    assert (trace_dir / "events.jsonl").exists() and (trace_dir / "trace.json").exists()
    assert not telemetry.active() and telemetry.trace_dir() is None
    telemetry.set_trace_dir(trace_dir)
    with telemetry.enabled(True):
        with ERService(res.serving_state, max_batch=8, device="cpu") as svc:
            xq = np.zeros(res.serving_state.n_predictors)
            for _ in range(3):
                svc.query(res.serving_state.n_months - 1, xq)
    records = [json.loads(line)
               for line in (trace_dir / "events.jsonl").read_text().splitlines()]
    spans = [r for r in records if r["type"] == "span"]
    names = {s["name"] for s in spans}
    assert set(res.timer.durations) <= names
    for expected in ("run_pipeline", "load_raw_data", "build_panel", "table_1", "table_2",
                     "decile_table", "serving_state", "serving.batch", "serving.dispatch"):
        assert expected in names, expected
    root = next(s for s in spans if s["name"] == "run_pipeline")
    t1 = next(s for s in spans if s["name"] == "table_1")
    assert t1["parent_id"] == root["span_id"] and t1["trace_id"] == root["trace_id"]
    inner = next(s for s in spans if s["name"] == "factors/daily_kernels")
    build = next(s for s in spans if s["name"] == "build_panel")
    assert inner["trace_id"] == root["trace_id"] and build["parent_id"] == root["span_id"]
    programs = [r for r in records if r["type"] == "program"]
    assert {p["bucket"] for p in programs} >= {1, 2, 4, 8}
    doc = json.loads((trace_dir / "trace.json").read_text())
    chrome = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "table_2" in chrome and "serving.dispatch" in chrome


def test_traced_run_artifacts_are_bit_identical(tmp_path):
    """Tracing off and on: the artifact files' sha256s and the kernel
    launch counters are equal; the traced run wrote its traces."""
    runs = {}
    for name, kw in (("off", {}), ("on", {"trace_dir": tmp_path / "trace"})):
        for counter in (rolling_reduce_cuda, gram_contract_cuda,
                        masked_cumulative_moments_cuda):
            counter.launches = 0
        out = tmp_path / name
        run_pipeline(**RUN, output_dir=out, **kw)
        runs[name] = (_artifact_digests(out), _counters())
    assert runs["on"] == runs["off"]
    assert {"table_1.pkl", "table_2.pkl", "serving_state.npz"} <= set(runs["on"][0])
    assert (tmp_path / "trace" / "events.jsonl").exists()


def test_fama_macbeth_bit_identical_telemetry_on_vs_off():
    from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth

    y, x, mask = (torch.tensor(a) for a in _data(seed=11))
    with telemetry.enabled(False):
        off = fama_macbeth(y, x, mask)
    with telemetry.enabled(True):
        on = fama_macbeth(y, x, mask)
    def flat(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [leaf for item in tree for leaf in flat(item)]

    leaves = list(zip(flat(off), flat(on)))
    assert leaves
    for a, b in leaves:
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


# -- per-process identity ----------------------------------------------------


def test_process_identity_precedence(monkeypatch):
    identity.set_process_index(None)
    assert identity.process_index() is None and identity.process_suffix() == ""
    monkeypatch.setenv("FMRP_DIST_PROC_ID", "3")
    assert identity.process_index() == 3
    monkeypatch.setenv("FMRP_PROC_INDEX", "7")
    assert identity.process_index() == 7
    identity.set_process_index(2)
    try:
        assert identity.process_index() == 2 and identity.process_suffix() == "[p2]"
    finally:
        identity.set_process_index(None)


def test_prometheus_export_carries_process_index_only_when_armed():
    reg = MetricsRegistry()
    reg.counter("fmrp_test_ident_total", help="h", route="a").inc(2)
    reg.gauge("fmrp_test_ident_gauge", help="h").set(1.5)
    unarmed = reg.to_prometheus()
    assert "process_index" not in unarmed
    identity.set_process_index(4)
    try:
        armed = reg.to_prometheus()
    finally:
        identity.set_process_index(None)
    for line in armed.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        assert 'process_index="4"' in line, line
    assert reg.to_prometheus() == unarmed


def test_jsonl_meta_and_chrome_trace_carry_identity(tmp_path):
    with telemetry.enabled(True):
        with telemetry.span("ident.work", cat="test"):
            pass
        meta_off = json.loads(export.write_jsonl(tmp_path / "off.jsonl").read_text()
                              .splitlines()[0])
        assert "process_index" not in meta_off
        assert export.chrome_trace_events()[0]["args"]["name"] == "fmrp-host"
        identity.set_process_index(5)
        try:
            meta_on = json.loads(export.write_jsonl(tmp_path / "on.jsonl").read_text()
                                 .splitlines()[0])
            assert meta_on["process_index"] == 5
            assert export.chrome_trace_events()[0]["args"]["name"] == "fmrp-host[p5]"
            assert export.jsonl_name() == "events.p5.jsonl"
        finally:
            identity.set_process_index(None)
