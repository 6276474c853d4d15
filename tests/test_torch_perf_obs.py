"""The port's performance-observability plane vs ``tests/test_perf_obs.py``
and the JAX package's, on the CPU: the cost ledger, the profiler capture,
the flight recorder, the build-cache sentinel, the SLO monitor and the
Prometheus edge cases.

- The cost ledger holds one record per serving bucket built (an eager
  callable here, a captured CUDA graph on the card) with the bucket's
  analytic FLOPs and bytes, and the records ride the exporters (JSONL
  ``program`` lines with the JAX record's keys, Chrome slices and counter
  tracks, ``fmrp_program_*`` families); ``record_runtime`` sets the
  roofline gauges against ``peak_flops_estimate`` (the H100's published
  figure on that card, never a TPU figure).
- ``profiling`` on the CPU writes a Chrome trace carrying the span names,
  refuses nesting, and refuses a CUDA capture it cannot make;
  ``device_busy_share`` and ``profile_kernel_counts`` read a trace.
- The flight recorder is a no-op unarmed and is written on a quarantine.
- The rebuild sentinel counts and attributes build-cache growth in a warm
  region and never warns in a cold one.
- SLOs: the same synthetic stream under an injected clock gives the same
  snapshot sequence in both packages; states move ok → warn → breach →
  ok; the service surfaces them in ``stats()`` and ``/metrics``.
- Prometheus: hostile label values and HELP text are escaped, histograms
  render consistently under concurrent updates, and the endpoint serves
  the exposition content type.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.telemetry import slo as jax_slo
from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.telemetry import export
from fm_returnprediction_tpu_torch.telemetry import metrics as tmetrics
from fm_returnprediction_tpu_torch.telemetry import perf as tperf
from fm_returnprediction_tpu_torch.telemetry import slo as tslo

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    telemetry.set_trace_dir(None)
    yield
    telemetry.reset()
    telemetry.set_trace_dir(None)


def _serving_state(t=24, n=40, p=4, seed=5):
    from fm_returnprediction_tpu_torch.serving import build_serving_state

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p)).astype(np.float32)
    y = (0.1 * rng.standard_normal((t, n))).astype(np.float32)
    mask = rng.random((t, n)) > 0.2
    y = np.where(mask, y, np.nan).astype(np.float32)
    return build_serving_state(torch.tensor(y), torch.tensor(x), torch.tensor(mask),
                               window=12, min_periods=6), x


# -- cost ledger ------------------------------------------------------------


def test_record_program_records_cost_and_metrics():
    before = len(tperf.cost_ledger().records())
    rec = telemetry.record_program("obs_test_probe", "B=4,P=2,float64", 0.25,
                                   backend="cpu", flops=16.0, bytes_accessed=96.0,
                                   argument_bytes=72, output_bytes=32, bucket=4)
    records = tperf.cost_ledger().records()[before:]
    assert records == [rec]
    assert rec.compile_s == 0.25 and rec.lower_s == 0.0 and rec.provenance == "captured"
    assert rec.fingerprint and rec.seq > 0 and rec.temp_bytes is None
    collected = telemetry.registry().collect()
    assert collected["fmrp_program_compiles_total"][
        (("program", "obs_test_probe"), ("provenance", "captured"))] == 1
    assert collected["fmrp_program_flops"][(("program", "obs_test_probe"),)] == 16.0


def test_serving_executor_buckets_land_in_ledger():
    from fm_returnprediction_tpu_torch.serving.executor import BucketedExecutor

    state, _ = _serving_state()
    mark = tperf.cost_ledger().last_seq
    exe = BucketedExecutor(state, max_batch=8, device="cpu")
    exe.warmup()
    new = [r for r in tperf.cost_ledger().since(mark) if r.program == "serving_bucket"]
    assert sorted(r.bucket for r in new) == list(exe.buckets())
    for r in new:
        assert r.provenance == "eager" and r.backend == "cpu" and r.compile_s >= 0
        assert r.flops == 2 * state.n_predictors * r.bucket
        assert r.signature == f"B={r.bucket},P=4,float32"
        assert r.output_bytes == 4 * r.bucket
    exe.warmup()  # a second warm-up builds nothing
    assert len([r for r in tperf.cost_ledger().since(mark)
                if r.program == "serving_bucket"]) == len(new)


def test_program_records_ride_the_exporters(tmp_path):
    from fm_returnprediction_tpu.telemetry.perf import ProgramRecord as JaxRecord

    telemetry.record_program("obs_export_probe", "sig", 0.01, backend="cpu",
                             flops=8.0, bytes_accessed=64.0)
    jsonl = export.write_jsonl(tmp_path / "events.jsonl")
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    probe = next(r for r in records
                 if r["type"] == "program" and r["program"] == "obs_export_probe")
    want = {f for f in JaxRecord.__dataclass_fields__ if f != "t_ns"} | {"type", "ts_us"}
    assert set(probe) == want
    again = export.write_jsonl(tmp_path / "events2.jsonl")
    assert jsonl.read_bytes() == again.read_bytes()
    events = json.loads(export.write_chrome_trace(tmp_path / "trace.json").read_text())[
        "traceEvents"]
    assert any(e["ph"] == "C" and e["name"] == "program_flops" for e in events)
    assert any(e["ph"] == "X" and e["name"] == "compile:obs_export_probe" for e in events)
    assert any(e["ph"] == "M" and e["args"].get("name") == "fmrp-compiles" for e in events)


def test_record_runtime_sets_roofline_gauges():
    telemetry.record_program("obs_roofline_probe", "sig", 0.01, backend="cpu",
                             flops=2.0e6)
    out = telemetry.record_runtime("obs_roofline_probe", 0.01)
    assert out["achieved_flops"] == pytest.approx(2.0e8)
    assert 0 <= out["roofline_utilization"]
    text = telemetry.registry().to_prometheus()
    assert 'fmrp_program_achieved_flops{program="obs_roofline_probe"}' in text
    assert telemetry.record_runtime("does_not_exist", 1.0) == {}


def test_peak_flops_estimate(monkeypatch):
    monkeypatch.delenv("FMRP_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu = telemetry.peak_flops_estimate()
    assert cpu == pytest.approx(48e9 * (__import__("os").cpu_count() or 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert telemetry.peak_flops_estimate() == 67e12
    assert telemetry.peak_flops_estimate("bfloat16") == 989e12
    assert telemetry.peak_flops_estimate("float64") == 34e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Some Other Card")
    assert telemetry.peak_flops_estimate() == cpu  # an unknown card: the CPU rule
    monkeypatch.setenv("FMRP_PEAK_FLOPS", "1.5e12")
    assert telemetry.peak_flops_estimate() == 1.5e12
    assert 275e12 not in {v for peaks in tperf._CUDA_PEAKS.values() for v in peaks.values()}


# -- flight recorder --------------------------------------------------------


def test_dump_flight_unarmed_is_noop_and_armed_writes(tmp_path):
    assert telemetry.dump_flight("test.reason") is None
    with telemetry.enabled(True):
        with telemetry.span("flight_parent"):
            telemetry.event("flight_tick")
    telemetry.set_trace_dir(tmp_path)
    path = telemetry.dump_flight("test.reason")
    assert path is not None and path.name == "flight.json"
    doc = json.loads(path.read_text())
    assert doc["type"] == "flight" and doc["reason"] == "test.reason"
    assert any(s["name"] == "flight_parent" for s in doc["spans"])
    assert {"programs", "metrics", "collector"} <= set(doc)


def test_quarantine_dumps_flight(tmp_path):
    from fm_returnprediction_tpu_torch.serving import ERService

    state, x = _serving_state()
    telemetry.set_trace_dir(tmp_path)
    with telemetry.enabled(True):
        with ERService(state, max_batch=8, auto_flush=False, device="cpu") as svc:
            bad = np.full((40, x.shape[-1]), np.nan, dtype=np.float32)
            ok = svc.ingest_month(np.full(40, np.nan), bad, np.ones(40, bool),
                                  np.datetime64("2071-01-31", "ns"))
            assert not ok and svc.degraded
    doc = json.loads((tmp_path / "flight.json").read_text())
    assert doc["reason"].startswith("serving.quarantine:")


# -- rebuild sentinel --------------------------------------------------------


def test_recompile_watch_counts_and_attributes(monkeypatch):
    entries = iter([10, 12])
    monkeypatch.setattr(tmetrics, "cuda_build_cache_stats",
                        lambda build_dir=None: {"entries": next(entries), "bytes": 0})
    counter = telemetry.registry().counter("fmrp_unexpected_recompiles_total",
                                           section="warm_probe")
    base = counter.value
    with pytest.warns(UserWarning, match="warm region 'warm_probe' grew"):
        with telemetry.recompile_watch("warm_probe", warm=True) as delta:
            telemetry.record_program("warm_probe_prog", "sig", 0.1, backend="cpu")
    assert delta.grew == 2
    assert any("warm_probe_prog@" in c for c in delta.culprits)
    assert counter.value == base + 2


def test_recompile_watch_cold_region_never_warns(monkeypatch):
    import warnings

    entries = iter([10, 12])
    monkeypatch.setattr(tmetrics, "cuda_build_cache_stats",
                        lambda build_dir=None: {"entries": next(entries), "bytes": 0})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with telemetry.recompile_watch("cold_probe", warm=False) as delta:
            pass
    assert delta.grew == 2


# -- profiler ----------------------------------------------------------------


def test_profiling_arms_span_annotations(tmp_path):
    assert not tperf.profiler_active() and not telemetry.active()
    with telemetry.profiling(tmp_path / "prof", device="cpu") as where:
        assert where == str(tmp_path / "prof")
        assert tperf.profiler_active() and telemetry.active()
        with telemetry.span("profiled_region"):
            torch.ones(64).sum()
        with pytest.raises(RuntimeError, match="already active"):
            with telemetry.profiling(tmp_path / "prof2", device="cpu"):
                pass
    assert not tperf.profiler_active() and not telemetry.active()
    trace = tmp_path / "prof" / tperf.PROFILE_TRACE_NAME
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "profiled_region"
               for e in events)
    with telemetry.profiling(None):
        assert not tperf.profiler_active()
    assert any(s.name == "profiled_region" for s in telemetry.finished_spans())


def test_profiling_refuses_a_capture_it_cannot_make(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with telemetry.profiling(tmp_path / "p"):
            pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="no CUPTI"):
        with telemetry.profiling(tmp_path / "p", device="cuda"):
            pass
    assert not tperf.profiler_active()


def test_device_busy_share_and_kernel_counts():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "stage", "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "stage", "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void rolling_reduce_kernel<float, 2>(...)",
         "ts": 110.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "void gram_kernel<float, float, false>(...)",
         "ts": 120.0, "dur": 20.0},              # overlaps the first: union 30
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 190.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "void gram_tc_kernel<1, 2, 3, true>(...)",
         "ts": 420.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise", "ts": 600.0,
         "dur": 50.0},
    ]}
    share, window_s, n = telemetry.perf.device_busy_share(trace, "stage")
    assert n == 2 and window_s == pytest.approx(200e-6)
    assert share == pytest.approx((30 + 10 + 10) / 200)
    counts = telemetry.perf.profile_kernel_counts(
        trace, {"k1": r"\brolling_reduce_kernel\b", "k2": r"\bgram(_tc)?_kernel\b"})
    assert counts == {"k1": 1, "k2": 2}
    with pytest.raises(KeyError):
        telemetry.perf.device_busy_share(trace, "absent")


# -- SLO monitor ------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _slo_stream(mod):
    """One synthetic stream through a package's monitor under an injected
    clock: the snapshot after every phase."""
    clock = _Clock()
    objectives = (mod.SLO("p99", "latency", threshold_ms=10.0, budget=0.10),
                  mod.SLO("errors", "error_rate", budget=0.05),
                  *mod.slos_from_env({"FMRP_SLO_QUEUE": "0.8"}))
    mon = mod.SloMonitor(objectives, window_s=10.0, clock=clock)
    snaps = []
    for phase in ((100, 0.001, True, 0.5), (12, 0.050, True, 0.7), (30, 0.050, True, 0.95),
                  (6, None, False, 0.2), (20, 0.001, True, 0.1)):
        count, lat, ok, queue = phase
        if count == 20:
            clock.t += 11.0
        for _ in range(count):
            mon.observe(lat, ok=ok)
        mon.observe_queue(queue)
        snaps.append(mon.snapshot())
        clock.t += 0.5
    return snaps, mon.worst_burn()


def test_slo_state_sequence_equals_the_jax_monitor():
    port, ref = _slo_stream(tslo), _slo_stream(jax_slo)
    assert port == ref
    states = [s["objectives"]["p99"]["state"] for s in port[0][:3]] + \
        [port[0][-1]["objectives"]["p99"]["state"]]
    assert states == ["ok", "warn", "breach", "ok"]


def test_slo_state_transitions_ok_warn_breach_recover():
    clock = _Clock()
    slo = tslo.SLO("p99", "latency", threshold_ms=10.0, budget=0.10, warn_burn=1.0,
                   breach_burn=2.0)
    mon = tslo.SloMonitor((slo,), window_s=10.0, clock=clock)
    for _ in range(100):
        mon.observe(0.001)
    assert mon.snapshot()["objectives"]["p99"]["state"] == "ok"
    for _ in range(12):
        mon.observe(0.050)
    snap = mon.snapshot()
    assert snap["objectives"]["p99"]["state"] == "warn" and snap["state_code"] == 1
    for _ in range(30):
        mon.observe(0.050)
    assert mon.snapshot()["state_code"] == 2
    clock.t += 11.0
    for _ in range(20):
        mon.observe(0.001)
    snap = mon.snapshot()
    assert snap["objectives"]["p99"]["state"] == "ok" and snap["n"] == 20


def test_slo_error_rate_and_reject_samples():
    clock = _Clock()
    mon = tslo.SloMonitor((tslo.SLO("errors", "error_rate", budget=0.05),), window_s=60.0,
                          clock=clock)
    for _ in range(95):
        mon.observe(0.001, ok=True)
    for _ in range(5):
        mon.observe(None, ok=False)
    snap = mon.snapshot()
    assert snap["error_rate"] == pytest.approx(0.05)
    assert snap["objectives"]["errors"]["burn_rate"] == pytest.approx(1.0)
    assert snap["objectives"]["errors"]["state"] == "warn" and snap["p99_ms"] is not None


def test_slo_queue_breach_is_reachable():
    slo = tslo.slos_from_env({"FMRP_SLO_QUEUE": "0.8"})[0]
    mon = tslo.SloMonitor((slo,), window_s=60.0, clock=_Clock())
    for occ, state in ((0.5, "ok"), (0.7, "warn"), (0.95, "breach")):
        mon.observe_queue(occ)
        assert mon.snapshot()["objectives"]["queue_occupancy"]["state"] == state
    assert mon.snapshot()["objectives"]["queue_occupancy"]["burn_rate"] == \
        pytest.approx(0.95 / 0.8)


def test_slo_validation():
    with pytest.raises(ValueError, match="kind"):
        tslo.SLO("x", "bogus")
    with pytest.raises(ValueError, match="threshold_ms"):
        tslo.SLO("x", "latency")
    with pytest.raises(ValueError, match="budget"):
        tslo.SLO("x", "error_rate", budget=0.0)
    with pytest.raises(ValueError, match="warn"):
        tslo.SLO("x", "latency", threshold_ms=1.0, warn_burn=2.0, breach_burn=1.0)
    with pytest.raises(ValueError, match="duplicate"):
        tslo.SloMonitor((tslo.SLO("a", "error_rate", budget=0.1),
                         tslo.SLO("a", "error_rate", budget=0.2)))


def test_slos_from_env_equal_the_jax_package():
    env = {"FMRP_SLO_P99_MS": "25", "FMRP_SLO_P50_MS": "5", "FMRP_SLO_ERROR_RATE": "0.02",
           "FMRP_SLO_QUEUE": "0.9", "FMRP_SLO_WARN_BURN": "0.5", "FMRP_SLO_WINDOW_S": "30"}
    port, ref = tslo.slos_from_env(env), jax_slo.slos_from_env(env)
    assert [vars(s) for s in port] == [vars(s) for s in ref]
    assert {s.name for s in port} == {"p99_latency", "p50_latency", "error_rate",
                                      "queue_occupancy"}
    assert tslo.env_window_s(env) == jax_slo.env_window_s(env) == 30.0
    assert tslo.slos_from_env({}) == ()


def test_erservice_slo_in_stats_and_metrics():
    from fm_returnprediction_tpu_torch.serving import ERService

    state, x = _serving_state()
    t = state.n_months
    slos = (tslo.SLO("p99_latency", "latency", threshold_ms=1e4),)
    with ERService(state, max_batch=8, auto_flush=False, slos=slos, device="cpu") as svc:
        svc.submit(t - 1, x[t - 1, 0])
        svc.batcher.drain()
        stats = svc.stats()
        assert stats["slo_state"] == "ok" and stats["slo_state_code"] == 0
        assert stats["slo"]["p99_latency"]["burn_rate"] == 0.0
        text = svc.prometheus_metrics()
    assert 'fmrp_slo_state{slo="p99_latency"} 0' in text
    assert 'fmrp_slo_burn_rate{slo="p99_latency"}' in text
    assert "fmrp_serving_service_slo_state_code 0" in text


def test_erservice_without_slos_reports_none():
    from fm_returnprediction_tpu_torch.serving import ERService

    state, _ = _serving_state()
    with ERService(state, max_batch=8, auto_flush=False, device="cpu") as svc:
        stats = svc.stats()
    assert stats["slo_state"] is None and "slo" not in stats


# -- Prometheus text-format edge cases --------------------------------------


def test_label_values_are_escaped():
    reg = telemetry.registry()
    reg.counter("fmrp_test_escape_total", help="escape probe",
                detail='say "hi"\\path\nnewline').inc()
    (line,) = [line for line in reg.to_prometheus().splitlines()
               if line.startswith("fmrp_test_escape_total{")]
    assert '\\"hi\\"' in line and "\\\\path" in line and "\\nnewline" in line


def test_help_lines_are_escaped():
    reg = telemetry.registry()
    reg.counter("fmrp_test_help_total", help="line1\nline2 \\ slash").inc()
    (help_line,) = [line for line in reg.to_prometheus().splitlines()
                    if line.startswith("# HELP fmrp_test_help_total")]
    assert help_line == "# HELP fmrp_test_help_total line1\\nline2 \\\\ slash"


def _parse_histogram(text, name):
    buckets, hsum, count = [], None, None
    for line in text.splitlines():
        if line.startswith(f"{name}_bucket"):
            buckets.append(float(line.rsplit(" ", 1)[1]))
        elif line.startswith(f"{name}_sum"):
            hsum = float(line.rsplit(" ", 1)[1])
        elif line.startswith(f"{name}_count"):
            count = float(line.rsplit(" ", 1)[1])
    return buckets, hsum, count


def test_histogram_rendering_under_concurrent_updates():
    reg = telemetry.registry()
    hist = reg.histogram("fmrp_test_concurrent_seconds", buckets=(0.001, 0.01, 0.1, 1.0))
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            hist.observe(0.005)
            hist.observe(0.5)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        for _ in range(20):
            buckets, hsum, count = _parse_histogram(reg.to_prometheus(),
                                                    "fmrp_test_concurrent_seconds")
            assert len(buckets) == 5 and buckets == sorted(buckets)
            assert buckets[-1] == count and hsum >= 0
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)


def test_metrics_server_content_type_and_help_type_lines():
    from fm_returnprediction_tpu_torch.serving import ERService

    state, x = _serving_state()
    t = state.n_months
    with ERService(state, max_batch=8, auto_flush=False, device="cpu") as svc:
        svc.submit(t - 1, x[t - 1, 0])
        svc.batcher.drain()
        host, port = svc.start_metrics_server()
        with pytest.raises(RuntimeError, match="already running"):
            svc.start_metrics_server()
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "text/plain; version=0.0.4"
            body = resp.read().decode()
    lines = body.splitlines()
    seen_type = {}
    for i, line in enumerate(lines):
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            assert kind in ("counter", "gauge", "histogram") and name not in seen_type
            seen_type[name] = i
            if i and lines[i - 1].startswith("# HELP "):
                assert lines[i - 1].split(" ")[2] == name
        elif line and not line.startswith("#"):
            metric = line.split("{", 1)[0].split(" ", 1)[0]
            family = metric
            for suffix in ("_bucket", "_sum", "_count"):
                if metric.endswith(suffix) and metric[: -len(suffix)] in seen_type:
                    family = metric[: -len(suffix)]
                    break
            if family in seen_type:
                assert seen_type[family] < i
    assert "fmrp_serving_requests_done_total" in seen_type
    assert "fmrp_serving_request_latency_seconds" in seen_type
    assert "fmrp_cuda_build_cache_entries" in seen_type
