"""Trace and metrics exporters: JSONL event log, Chrome trace, Prometheus text.

Three consumers, three formats, one span store:

- :func:`write_jsonl`: the structured event log (``events.jsonl``), one
  JSON object per line, ``type`` in {``meta``, ``span``, ``event``,
  ``program``, ``metrics``}, timestamps in epoch microseconds,
  deterministic key and record order (start time, then span id), so two
  exports of the same collector state are byte-identical;
- :func:`write_chrome_trace`: Chrome trace-event format (``trace.json``):
  ``X`` complete events for spans, ``i`` instants for events, ``M`` rows
  naming the process and threads, and the cost ledger's program records
  (serving bucket captures) as ``X`` slices and ``C`` counter tracks on
  an ``fmrp-compiles`` row. It loads in Perfetto; the timestamps are
  epoch-anchored, so a ``torch.profiler`` trace of the same run lines up
  beside it;
- :func:`prometheus_text`: the registry in Prometheus exposition format,
  followed by the ``fmrp_build_info`` gauge; ``ERService``'s metrics
  endpoint serves it (:func:`serve_metrics_http`).

:func:`export_all` writes both trace files into a directory (the
``FMRP_TRACE_DIR`` / ``--trace-dir`` sink), rewriting whole files from the
collector on every call, so repeated flushes (end of ``run_pipeline``,
``ERService.close``, interpreter exit) are idempotent.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

from fm_returnprediction_tpu_torch.telemetry import metrics as _metrics
from fm_returnprediction_tpu_torch.telemetry import spans as _spans

__all__ = [
    "flat_metrics",
    "build_info",
    "span_record",
    "event_record",
    "program_record",
    "write_jsonl",
    "chrome_trace_events",
    "write_chrome_trace",
    "export_all",
    "prometheus_text",
    "serve_metrics_http",
    "JSONL_NAME",
    "CHROME_TRACE_NAME",
    "jsonl_name",
    "chrome_trace_name",
]

JSONL_NAME = "events.jsonl"
CHROME_TRACE_NAME = "trace.json"


def _proc_tag() -> str:
    from fm_returnprediction_tpu_torch.telemetry import identity as _identity

    k = _identity.process_index()
    return "" if k is None else f".p{k}"


def jsonl_name() -> str:
    """``events.jsonl``, or ``events.p{K}.jsonl`` under a multi-process
    identity, so N processes sharing one ``FMRP_TRACE_DIR`` never
    overwrite each other's export."""
    return f"events{_proc_tag()}.jsonl"


def chrome_trace_name() -> str:
    return f"trace{_proc_tag()}.json"


def _ts_us(t_ns: int) -> float:
    """perf_counter_ns → epoch microseconds (one anchor per process)."""
    return (t_ns + _spans.EPOCH_ANCHOR_NS) / 1e3


def flat_metrics() -> dict:
    """The registry snapshot as one flat ``name{k=v,...} → value`` dict:
    the shape of the JSONL ``metrics`` line and of the flight recorder's
    ``metrics`` field, flattened under ``metrics.SNAPSHOT_LOCK``."""
    out = {}
    with _metrics.SNAPSHOT_LOCK:
        for name, series in _metrics.registry().collect().items():
            for key, value in sorted(series.items()):
                label = ",".join(f"{k}={v}" for k, v in key)
                out[f"{name}{{{label}}}" if label else name] = value
    return out


_BUILD_INFO: Optional[dict] = None


def build_info() -> dict:
    """Label set of the ``fmrp_build_info`` gauge: the torch version, the
    CUDA version torch was built with, the compute device's name (the
    first CUDA device's, else ``cpu``) and a short sha of the package's
    ``__init__.py``: enough to attribute a scrape to an environment.
    Computed once per process."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        import hashlib

        import torch

        try:
            pkg_init = Path(__file__).resolve().parents[1] / "__init__.py"
            salt = hashlib.sha256(pkg_init.read_bytes()).hexdigest()[:8]
        except OSError:  # pragma: no cover - package always readable
            salt = "unknown"
        device = (torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")
        _BUILD_INFO = {
            "torch": str(torch.__version__),
            "cuda": str(torch.version.cuda or "none"),
            "device": device,
            "code_salt": salt,
        }
    return _BUILD_INFO


def _clean(attrs: dict) -> dict:
    """JSON-safe attrs: anything non-primitive goes through repr."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[str(k)] = v
        else:
            out[str(k)] = repr(v)[:200]
    return out


def span_record(s: "_spans.Span") -> dict:
    end_ns = s.t1_ns if s.t1_ns is not None else s.t0_ns
    return {
        "type": "span",
        "name": s.name,
        "cat": s.cat,
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id,
        "ts_us": round(_ts_us(s.t0_ns), 3),
        "dur_us": round((end_ns - s.t0_ns) / 1e3, 3),
        "thread_id": s.thread_id,
        "thread_name": s.thread_name,
        "attrs": _clean(s.attrs),
        "events": [
            {
                "name": name,
                "ts_us": round(_ts_us(t_ns), 3),
                "attrs": _clean(attrs),
            }
            for name, t_ns, attrs in s.events
        ],
    }


def event_record(e: dict) -> dict:
    return {
        "type": "event",
        "name": e["name"],
        "cat": e["cat"],
        "ts_us": round(_ts_us(e["t_ns"]), 3),
        "thread_id": e["thread_id"],
        "thread_name": e["thread_name"],
        "attrs": _clean(e["attrs"]),
    }


def program_record(r) -> dict:
    """One cost-ledger :class:`ProgramRecord` as a JSONL line (``type:
    "program"``): a serving bucket's analytic FLOPs and bytes and its
    capture time beside the spans that paid for it."""
    out = r.to_json()
    out["type"] = "program"
    out["ts_us"] = round(_ts_us(r.t_ns), 3)
    del out["t_ns"]
    return out


def _ordered_records() -> List[dict]:
    """Every collected span/event as records, deterministically ordered
    (start time, then span id — ties cannot reorder across exports)."""
    spans = sorted(
        _spans.finished_spans(), key=lambda s: (s.t0_ns, s.span_id)
    )
    events = sorted(
        _spans.standalone_events(), key=lambda e: (e["t_ns"], e["name"])
    )
    return [span_record(s) for s in spans] + [event_record(e) for e in events]


def write_jsonl(path, include_metrics: bool = True) -> Path:
    """The structured event log: a ``meta`` header line, one line per
    span/standalone event, and (by default) a final ``metrics`` snapshot
    of the registry."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    stats = _spans.collector_stats()
    meta = {
        "type": "meta",
        "schema": 1,
        "pid": os.getpid(),
        "spans": stats["spans"],
        "events": stats["events"],
        "dropped": stats["dropped"],
        # this process's perf_counter → epoch anchor
        "anchor_ns": _spans.EPOCH_ANCHOR_NS,
    }
    # per-process identity (multi-process runs); absent when unarmed
    from fm_returnprediction_tpu_torch.telemetry import identity as _identity

    if _identity.process_index() is not None:
        meta["process_index"] = _identity.process_index()
    lines = [json.dumps(meta, sort_keys=True)]
    lines += [json.dumps(r, sort_keys=True) for r in _ordered_records()]
    from fm_returnprediction_tpu_torch.telemetry import perf as _perf

    lines += [
        json.dumps(program_record(r), sort_keys=True)
        for r in _perf.cost_ledger().records()
    ]
    if include_metrics:
        lines.append(
            json.dumps(
                {"type": "metrics", "values": flat_metrics()},
                sort_keys=True,
            )
        )
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    tmp.write_text("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return path


def chrome_trace_events(pid: Optional[int] = None) -> List[dict]:
    """Chrome trace-event dicts for every collected span and event."""
    pid = os.getpid() if pid is None else pid
    from fm_returnprediction_tpu_torch.telemetry import identity as _identity

    out: List[dict] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            # "[pK]" under a multi-process identity
            "args": {"name": f"fmrp-host{_identity.process_suffix()}"},
        }
    ]
    threads = {}
    spans = sorted(
        _spans.finished_spans(), key=lambda s: (s.t0_ns, s.span_id)
    )
    for s in spans:
        threads.setdefault(s.thread_id, s.thread_name)
    for e in _spans.standalone_events():
        threads.setdefault(e["thread_id"], e["thread_name"])
    for tid, name in sorted(threads.items()):
        out.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )
    for s in spans:
        end_ns = s.t1_ns if s.t1_ns is not None else s.t0_ns
        out.append(
            {
                "ph": "X",
                "name": s.name,
                "cat": s.cat,
                "ts": round(_ts_us(s.t0_ns), 3),
                "dur": round((end_ns - s.t0_ns) / 1e3, 3),
                "pid": pid,
                "tid": s.thread_id,
                "args": {
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    **_clean(s.attrs),
                },
            }
        )
        for name, t_ns, attrs in s.events:
            out.append(
                {
                    "ph": "i",
                    "name": name,
                    "cat": "event",
                    "ts": round(_ts_us(t_ns), 3),
                    "pid": pid,
                    "tid": s.thread_id,
                    "s": "t",
                    "args": {"span_id": s.span_id, **_clean(attrs)},
                }
            )
    for e in sorted(
        _spans.standalone_events(), key=lambda e: (e["t_ns"], e["name"])
    ):
        out.append(
            {
                "ph": "i",
                "name": e["name"],
                "cat": e["cat"],
                "ts": round(_ts_us(e["t_ns"]), 3),
                "pid": pid,
                "tid": e["thread_id"],
                "s": "t",
                "args": _clean(e["attrs"]),
            }
        )
    out.extend(_program_trace_events(pid))
    return out


#: synthetic tid of the compile row: bucket captures happen on real
#: threads, but one dedicated row keeps them together in Perfetto
_COMPILE_TID = 999_999


def _program_trace_events(pid: int) -> List[dict]:
    """Cost-ledger records as Chrome trace events: one ``X`` slice per
    program build (a bucket's capture, on a dedicated "fmrp-compiles" row)
    plus ``C`` counter tracks for FLOPs and bytes accessed, on the same
    timeline as the spans."""
    from fm_returnprediction_tpu_torch.telemetry import perf as _perf

    records = _perf.cost_ledger().records()
    if not records:
        return []
    out: List[dict] = [
        {
            "ph": "M",
            "name": "thread_name",
            "pid": pid,
            "tid": _COMPILE_TID,
            "args": {"name": "fmrp-compiles"},
        }
    ]
    for r in records:
        dur_ns = int((r.lower_s + r.compile_s) * 1e9)
        out.append(
            {
                "ph": "X",
                "name": f"compile:{r.program}",
                "cat": "compile",
                "ts": round(_ts_us(r.t_ns - dur_ns), 3),
                "dur": round(dur_ns / 1e3, 3),
                "pid": pid,
                "tid": _COMPILE_TID,
                "args": {
                    k: v
                    for k, v in r.to_json().items()
                    if v is not None and k != "t_ns"
                },
            }
        )
        for counter, value in (
            ("flops", r.flops),
            ("bytes_accessed", r.bytes_accessed),
            ("temp_bytes", r.temp_bytes),
        ):
            if value is None:
                continue
            out.append(
                {
                    "ph": "C",
                    "name": f"program_{counter}",
                    "ts": round(_ts_us(r.t_ns), 3),
                    "pid": pid,
                    "tid": _COMPILE_TID,
                    "args": {r.program: value},
                }
            )
    return out


def write_chrome_trace(path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    from fm_returnprediction_tpu_torch.telemetry import identity as _identity

    doc = {
        "traceEvents": chrome_trace_events(),
        "displayTimeUnit": "ms",
        # Perfetto ignores otherData; it records this process's anchor
        "otherData": {
            "anchor_ns": _spans.EPOCH_ANCHOR_NS,
            "pid": os.getpid(),
            "process_index": _identity.process_index(),
        },
    }
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    tmp.write_text(json.dumps(doc, sort_keys=True))
    os.replace(tmp, path)
    return path


def export_all(trace_dir) -> tuple:
    """Write ``events.jsonl`` + ``trace.json`` into ``trace_dir``; returns
    the two paths. Idempotent: whole-file rewrites from the collector."""
    trace_dir = Path(trace_dir)
    jsonl = write_jsonl(trace_dir / jsonl_name())
    chrome = write_chrome_trace(trace_dir / chrome_trace_name())
    return jsonl, chrome


def serve_metrics_http(render, port: int = 0, host: str = "127.0.0.1",
                       name: str = "fmrp-metrics"):
    """Serve ``render()`` (Prometheus text) over HTTP ``GET /metrics`` on
    a daemon thread: the scrape endpoint behind
    ``ERService.start_metrics_server``. Returns the
    ``ThreadingHTTPServer``: ``.server_address`` is the bound ``(host,
    port)`` (``port=0`` picks a free one); ``.shutdown()`` and
    ``.server_close()`` stop it."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib naming
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    threading.Thread(
        target=server.serve_forever, name=name, daemon=True
    ).start()
    return server


def prometheus_text(extra: Optional[dict] = None,
                    extra_prefix: str = "") -> str:
    """The registry in Prometheus text format, followed by an
    ``fmrp_build_info`` info gauge and optionally ``extra`` numeric
    gauges (an ``ERService`` renders its ``stats()`` dict through this:
    bools as 0/1, non-numbers skipped), under ``metrics.SNAPSHOT_LOCK``."""
    with _metrics.SNAPSHOT_LOCK:
        text = _metrics.registry().to_prometheus()
        lines = [text.rstrip("\n")] if text.strip() else []
        info = build_info()
        labels = ",".join(
            f'{k}="{_metrics.escape_label_value(v)}"'
            for k, v in sorted(info.items())
        )
        lines.append(
            "# HELP fmrp_build_info Build/environment identity"
            " (constant 1)."
        )
        lines.append("# TYPE fmrp_build_info gauge")
        lines.append(f"fmrp_build_info{{{labels}}} 1")
        if extra:
            for key in sorted(extra):
                value = extra[key]
                if isinstance(value, bool):
                    value = int(value)
                if not isinstance(value, (int, float)) or value != value:
                    continue  # skip None/lists/NaN
                name = _metrics.sanitize(f"{extra_prefix}{key}")
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {value}")
        return "\n".join(lines) + "\n"
