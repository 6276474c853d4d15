"""The merged multi-process timeline and per-hop request latency.

Every process of a fleet run exports its own ``events[.pK].jsonl`` /
``trace[.pK].json`` into the shared ``FMRP_TRACE_DIR`` (per-process
filenames, ``export.jsonl_name``). This module joins them:

- :func:`merge_traces` re-anchors every process's spans onto the router's
  epoch anchor and writes one Chrome/Perfetto document (``timeline.json``)
  with a named row per process. The alignment is exact:
  ``perf_counter_ns`` is ``CLOCK_MONOTONIC``, shared by the processes of
  one host, and each export's meta carries its process's epoch anchor, so
  ``aligned_us = ts_us + (anchor_router - anchor_proc) / 1e3``.

- :func:`analyze` reduces the merged spans to a per-hop latency table:
  p50/p99 per hop, each hop's share of the end-to-end p50
  (``fleet.request``), the summed attribution and the router-side share.
  With a journal, its records are counted for request coverage.

Command line::

    python -m fm_returnprediction_tpu_torch.telemetry.timeline \
        <journal|-> <trace-dir> [--out timeline.json]

Exit status: 0 on a merge with end-to-end coverage, 2 when the merge
holds no ``fleet.request`` span (a broken plane fails the run).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "HOPS",
    "ROUTER_HOPS",
    "E2E_SPAN",
    "load_process_traces",
    "merge_traces",
    "analyze",
    "format_table",
    "main",
]

#: the per-request hop chain, in wire order — contiguous segments of
#: one request's life, so their p50s should (approximately) sum to the
#: e2e p50; the gap is unattributed time
HOPS = (
    "hop.admit",          # router: submit() entry → row handed to transport
    "hop.coalesce",       # router: row enqueued → frame flushed to ring
    "hop.transport_req",  # wire: frame t_send → child decoded it
    "hop.solve",          # child: rows decoded → service completion
    "hop.result_send",    # child: completion → result frame t_send
    "hop.transport_resp",  # wire: result t_send → router received it
    "hop.complete",       # router: result received → future resolved
)

#: hops whose cycles are spent on the router process (the GIL-bound
#: ceiling candidates); transport_resp is included because its time is
#: dominated by the router read-loop draining, not the wire
ROUTER_HOPS = ("hop.admit", "hop.coalesce", "hop.transport_resp",
               "hop.complete")

E2E_SPAN = "fleet.request"


def _pctl(values: List[float], q: float) -> float:
    if not values:
        return float("nan")
    xs = sorted(values)
    idx = min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))
    return xs[idx]


def load_process_traces(trace_dir) -> List[dict]:
    """Parse every ``events*.jsonl`` under ``trace_dir`` into
    ``{"meta": ..., "records": [...]}`` — one entry per process."""
    trace_dir = Path(trace_dir)
    out = []
    for path in sorted(trace_dir.glob("events*.jsonl")):
        meta: dict = {}
        records: List[dict] = []
        try:
            lines = path.read_text().splitlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("type") == "meta":
                meta = rec
            else:
                records.append(rec)
        out.append({"path": str(path), "meta": meta, "records": records})
    return out


def _pick_router(procs: List[dict]) -> Optional[dict]:
    """The router is the export WITHOUT a process_index (the parent
    never sets one); fall back to the first file."""
    for p in procs:
        if p["meta"].get("process_index") is None:
            return p
    return procs[0] if procs else None


def merge_traces(trace_dir, out_name: str = "timeline.json"):
    """Write ONE Perfetto-loadable document merging every process's
    spans onto the router's clock. Returns ``(path, doc)``; ``path`` is
    None when there was nothing to merge."""
    trace_dir = Path(trace_dir)
    procs = load_process_traces(trace_dir)
    router = _pick_router(procs)
    if router is None:
        return None, {"traceEvents": []}
    anchor_router = router["meta"].get("anchor_ns", 0)
    events: List[dict] = []
    for p in procs:
        meta = p["meta"]
        off_us = (anchor_router - meta.get("anchor_ns", anchor_router)) / 1e3
        pid = meta.get("pid", 0)
        k = meta.get("process_index")
        if p is router:
            pname = "fmrp-router"
        elif k is not None:
            pname = f"fmrp-child[p{k}]"
        else:  # pragma: no cover - children always carry an index
            pname = f"fmrp-proc-{pid}"
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": pname},
        })
        threads: Dict[int, str] = {}
        for r in p["records"]:
            kind = r.get("type")
            if kind == "span":
                threads.setdefault(
                    r.get("thread_id", 0), r.get("thread_name", "thread")
                )
                events.append({
                    "ph": "X",
                    "name": r.get("name", "?"),
                    "cat": r.get("cat", "span"),
                    "ts": round(r.get("ts_us", 0.0) + off_us, 3),
                    "dur": r.get("dur_us", 0.0),
                    "pid": pid,
                    "tid": r.get("thread_id", 0),
                    "args": {
                        "trace_id": r.get("trace_id"),
                        "span_id": r.get("span_id"),
                        "parent_id": r.get("parent_id"),
                        **(r.get("attrs") or {}),
                    },
                })
            elif kind == "event":
                events.append({
                    "ph": "i",
                    "name": r.get("name", "?"),
                    "cat": r.get("cat", "event"),
                    "ts": round(r.get("ts_us", 0.0) + off_us, 3),
                    "pid": pid,
                    "tid": r.get("thread_id", 0),
                    "s": "t",
                    "args": r.get("attrs") or {},
                })
        for tid, tname in sorted(threads.items()):
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "router_anchor_ns": anchor_router,
            "processes": len(procs),
        },
    }
    path = trace_dir / out_name
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    tmp.write_text(json.dumps(doc, sort_keys=True))
    os.replace(tmp, path)
    return path, doc


def _read_journal(journal_path) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    try:
        lines = Path(journal_path).read_text().splitlines()
    except OSError:
        return counts
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        ev = rec.get("ev")
        if ev:
            counts[ev] = counts.get(ev, 0) + 1
    return counts


def analyze(trace_dir, journal_path=None) -> dict:
    """The per-hop latency table over the merged traces: per hop name
    ``{n, p50_ms, p99_ms, share_pct}`` (share of e2e p50), plus
    ``attributed_pct`` (summed hop shares), ``router_share_pct``
    (router-side hops only), process/journal coverage."""
    procs = load_process_traces(trace_dir)
    durs: Dict[str, List[float]] = {}
    for p in procs:
        for r in p["records"]:
            if r.get("type") != "span":
                continue
            name = r.get("name", "")
            if name in HOPS or name == E2E_SPAN:
                durs.setdefault(name, []).append(
                    r.get("dur_us", 0.0) / 1e3
                )
    e2e = durs.get(E2E_SPAN, [])
    e2e_p50 = _pctl(e2e, 50)
    hops = {}
    attributed = 0.0
    router_share = 0.0
    for name in HOPS:
        vals = durs.get(name)
        if not vals:
            continue
        p50 = _pctl(vals, 50)
        share = (100.0 * p50 / e2e_p50) if e2e_p50 and e2e_p50 > 0 else 0.0
        hops[name] = {
            "n": len(vals),
            "p50_ms": round(p50, 4),
            "p99_ms": round(_pctl(vals, 99), 4),
            "share_pct": round(share, 2),
        }
        attributed += share
        if name in ROUTER_HOPS:
            router_share += share
    return {
        "processes": len(procs),
        "requests": len(e2e),
        "e2e_p50_ms": round(e2e_p50, 4) if e2e else None,
        "e2e_p99_ms": round(_pctl(e2e, 99), 4) if e2e else None,
        "hops": hops,
        "attributed_pct": round(attributed, 2),
        "router_share_pct": round(router_share, 2),
        "journal": _read_journal(journal_path) if journal_path else {},
    }


def format_table(report: dict) -> str:
    lines = [
        f"merged {report['processes']} process trace(s), "
        f"{report['requests']} e2e request span(s)"
    ]
    if report.get("journal"):
        jr = report["journal"]
        lines.append(
            "journal: " + ", ".join(
                f"{k}={v}" for k, v in sorted(jr.items())
            )
        )
    lines.append(
        f"{'hop':<20}{'n':>8}{'p50_ms':>10}{'p99_ms':>10}{'share%':>8}"
    )
    for name in HOPS:
        h = report["hops"].get(name)
        if not h:
            continue
        lines.append(
            f"{name:<20}{h['n']:>8}{h['p50_ms']:>10.3f}"
            f"{h['p99_ms']:>10.3f}{h['share_pct']:>8.1f}"
        )
    if report.get("e2e_p50_ms") is not None:
        lines.append(
            f"e2e p50 {report['e2e_p50_ms']:.3f} ms  "
            f"p99 {report['e2e_p99_ms']:.3f} ms  |  "
            f"attributed {report['attributed_pct']:.1f}%  "
            f"router hops {report['router_share_pct']:.1f}%"
        )
    else:
        lines.append("no e2e spans — merge has no request coverage")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m fm_returnprediction_tpu_torch.telemetry.timeline",
        description="Merge per-process traces and print the per-hop "
                    "request latency table.",
    )
    parser.add_argument("journal", help="journal path, or '-' for none")
    parser.add_argument("trace_dir", help="directory of events*.jsonl")
    parser.add_argument("--out", default="timeline.json",
                        help="merged trace filename (in trace_dir)")
    ns = parser.parse_args(argv)
    journal = None if ns.journal == "-" else ns.journal
    path, doc = merge_traces(ns.trace_dir, out_name=ns.out)
    report = analyze(ns.trace_dir, journal_path=journal)
    print(format_table(report))
    if path is not None:
        n_rows = len({
            e["pid"] for e in doc["traceEvents"] if e.get("ph") == "M"
            and e.get("name") == "process_name"
        })
        print(f"wrote {path} ({n_rows} process row(s))")
    return 0 if report["requests"] else 2


if __name__ == "__main__":
    sys.exit(main())
