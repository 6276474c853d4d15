"""The benchmark's loop: set-up, a measured window, a traced stretch, the
comparison with the plain reference, and the result line.

A cell is data: ``BENCHMARK.json`` names it with its configuration and its
traffic, the module ``portbench/traffic/<traffic>.py`` (a ``Traffic``
class), and ``portbench/cells/<cell>.json`` gives its parameters and the
limit of every number its comparison gives. Every metric, end-to-end or
per-layer, is read by ``portbench/metrics/<metric>.py`` (a ``read(rec)``
that returns a number or None) from what the loop recorded. So a later cell,
configuration or metric is new files and new entries, and no edit here.

A ``Traffic`` has ``setup()`` (inputs from the seed, warm-up of the cell's own
shapes), ``call()`` (one timed call of the program, ended on the host with the
device idle), ``stage_seconds(out)``, ``work()`` (the counts its rooflines
need), ``outputs(out)`` (the answers, on the host), ``release()`` (frees the
program's device state), ``reference(dtype, tf32)`` and ``compare(got, ref)``
(the numbers held against the limits).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fm_returnprediction_tpu")
TRACE_WINDOW = "portbench.traced"
TRACE_SECONDS = 3.0


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}",
                                                  str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str):
    """``(benchmark, workload entry, cell file, configuration file)``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}[work["config"]]
    cell = json.loads((HERE / "cells" / f"{name}.json").read_text())
    config = json.loads((ROOT / cfg["file"]).read_text())
    return bench, work, cell, config


def make_traffic(work: dict, cell: dict, config: dict, seed: int, device: str,
                sizes: Optional[dict] = None):
    """The cell's traffic, built from its cell file and configuration."""
    return load_module(HERE / "traffic" / f"{work['traffic']}.py").Traffic(
        cell=cell, config=config, seed=seed, device=device, sizes=sizes)


def reported(bench: dict, cell_name: str, trace: bool):
    """The metric entries a run of ``cell_name`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in moved else [])]


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _synchronize(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _traced(drv, device):
    """One or more calls (at least ``TRACE_SECONDS``) under the profiler:
    ``(TraceView, calls)``. The program's stage spans name their intervals."""
    from torch.profiler import record_function

    from fm_returnprediction_tpu_torch.telemetry import profiling
    from portbench.trace import TraceView, load_events

    tdir = Path(tempfile.mkdtemp(prefix="portbench-trace-"))
    try:
        calls = 0
        with profiling(str(tdir), device=device):
            with record_function(TRACE_WINDOW):
                start = time.perf_counter()
                while calls < 1 or time.perf_counter() - start < TRACE_SECONDS:
                    drv.call()
                    calls += 1
        trace_file = tdir / "profile_trace.json"
        print(f"trace file {trace_file.stat().st_size} bytes", file=sys.stderr)
        events = load_events(trace_file)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    return TraceView(events, TRACE_WINDOW), calls


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             sizes: Optional[dict] = None, t0: Optional[float] = None):
    """One run of cell ``name``: ``(result dict, compared numbers)``."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    bench, work, cell, config = load_cell(name)
    drv = make_traffic(work, cell, config, seed, device, sizes)
    started = time.perf_counter() - t0
    drv.setup()
    _synchronize(device)
    setup_s = time.perf_counter() - t0
    print(f"setup_s {setup_s:.3f} (before the traffic {started:.3f}; "
          f"{json.dumps(drv.phases)})", file=sys.stderr)

    stage_sum: Dict[str, float] = {}
    attempted = failed = 0
    last = None
    call_s = []
    w0 = time.perf_counter()
    while True:
        attempted += 1
        c0 = time.perf_counter()
        try:
            last = drv.call()
        except Exception:  # a call that fails is counted, and the run is not correct
            failed += 1
            traceback.print_exc()
        else:
            for k, v in drv.stage_seconds(last).items():
                stage_sum[k] = stage_sum.get(k, 0.0) + v
        call_s.append(time.perf_counter() - c0)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    done = attempted - failed
    if stage_sum:
        print("stage means " + json.dumps({k: round(v / max(done, 1), 4)
                                           for k, v in stage_sum.items()}), file=sys.stderr)
    print(f"window {window_s:.3f} s, {attempted} calls, {failed} failed; the first and last "
          f"calls {[round(c, 4) for c in call_s[:8]]} {[round(c, 4) for c in call_s[-3:]]}",
          file=sys.stderr)

    view, traced_calls = (None, 0)
    if trace:
        t1 = time.perf_counter()
        view, traced_calls = _traced(drv, device)
        print(f"traced {traced_calls} calls in {view.window_s:.3f} s; capture and reading "
              f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    cuda = str(device).startswith("cuda")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    rec = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=done,
        stage_means={k: v / max(done, 1) for k, v in stage_sum.items()},
        trace=view, traced_calls=traced_calls, work=drv.work(), device=device)
    metrics = {}
    for m in reported(bench, name, trace):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    got = drv.outputs(last) if last is not None else None
    del last
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    compared: Dict[str, dict] = {}
    correct = False
    if got is not None:
        r0 = time.perf_counter()
        ref = drv.reference(torch.float64, tf32=False)
        numbers = drv.compare(got, ref)
        ref_s = time.perf_counter() - r0
        print(f"reference and comparison: {ref_s:.3f} s", file=sys.stderr)
        extra = {k: v for k, v in numbers.items() if k not in cell["limits"]}
        if extra:
            print("readings not compared: " + json.dumps(extra), file=sys.stderr)
        compared = {k: {"value": numbers.get(k, math.inf), "limit": lim}
                    for k, lim in cell["limits"].items()}
        correct = failed == 0 and all(
            isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
            and c["value"] <= c["limit"] for c in compared.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(work.get("chips", 1)), "memory_peak_bytes": peak}
    if trace and view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and view is not None:
        result["breakdown"] = {"device_ops": view.top_ops(), "idle_gaps": view.idle_by_span()}
    result["compared"] = compared
    return result, compared


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key in [k for k in os.environ if k.startswith("FMRP_")]:
        del os.environ[key]  # the program's knobs stay at their defaults

    import torch

    print(f"torch imported at {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    _, work, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work["chips"]):
        print(f"{args.workload} needs {work['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"cards counted at {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    result, compared = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                device="cuda", t0=t0)
    limit = _power_limit()
    if limit:
        print(f"card: {limit}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone", file=sys.stderr)
        return 4
    for key, c in compared.items():
        print(f"compared {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
