"""Perf-regression sentinel over the bench-history artifacts.

A bench run prints one JSON line per round, archived as
``BENCH_rNN.json``. This sentinel turns the trajectory into a typed,
gateable report:

    python -m fm_returnprediction_tpu_torch.telemetry.regress BENCH_*.json

- every numeric leaf of each round's ``{metric, value, extra}`` payload
  becomes a **series** (nested dicts flatten to dotted keys:
  ``real_pipeline_stage_s.table_2``), qualified by the section's
  ``*_shape`` disclosure and the round's ``device``
  (``kernel_fm_boot_warm_s@T720_N6000_B10000@cpu``) — a resized section
  or a different platform is a DIFFERENT series, never gated against the
  old one (``_series_key``);
- series are classified by direction from their naming convention
  (``*_s``/``*_ms``/``*_mb``/``*_pct`` lower-is-better; ``*_qps``/
  ``*speedup*``/``*_per_s`` throughputs (rows_per_s, cells_per_s)/
  ``*_utilization`` roofline gauges/``vs_baseline`` higher-is-better —
  the throughput check precedes the ``*_s`` seconds check; anything else
  is reported but never gated);
- per series, the **noise band** is fitted from the history itself: the
  robust scale of the *worsening* consecutive steps (improvements are
  the expected trajectory, not noise), floored at ``floor_rel`` (25%).
  The latest round regresses when it is worse than the **best** round in
  history by more than the band (and by more than ``abs_floor`` in the
  metric's own units — a 0.001 s stage doubling to 0.002 s is not a
  finding); it improves when it sets a new best.

The report is a :class:`RegressionReport` of :class:`MetricVerdict` rows,
consumable as JSON (``--json``) or as a gate (exit 1 on any
``regressed`` verdict; ``--no-fail`` reports only). It reads the same
artifacts and gives the same report as the reference package's sentinel.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import math
import re
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BenchRound",
    "MetricVerdict",
    "RegressionReport",
    "load_round",
    "load_rounds",
    "build_series",
    "direction",
    "analyze",
    "main",
]

#: statuses a verdict can carry; only "regressed" gates
STATUSES = ("regressed", "improved", "ok", "new", "missing", "skipped")

_ROUND_RE = re.compile(r"r(\d+)")


@dataclasses.dataclass(frozen=True)
class BenchRound:
    """One parsed bench artifact: its label, order key, and numeric leaves."""

    label: str
    order: Tuple[int, str]
    metric: str
    value: float
    values: Dict[str, float]  # flattened numeric leaves incl. the headline
    shapes: Dict[str, str] = dataclasses.field(default_factory=dict)
    # ``*_shape`` string leaves ("kernel_shape": "T720_N6000_B10000"):
    # the section-size disclosures every bench section publishes
    device: Optional[str] = None  # the round's ``extra.device`` platform
    # deliberately disabled sections: ``{"<section>": {"disabled": why}}``
    # in the round meta, disclosed by the sentinel and never gated
    disabled: Dict[str, str] = dataclasses.field(default_factory=dict)


def _flatten(prefix: str, obj, out: Dict[str, float],
             shapes: Optional[Dict[str, str]] = None,
             disabled: Optional[Dict[str, str]] = None) -> None:
    if isinstance(obj, dict):
        why = obj.get("disabled")
        if isinstance(why, str) and disabled is not None and prefix:
            disabled[prefix] = why
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out, shapes,
                     disabled)
    elif isinstance(obj, bool):
        return  # bools are flags, not measurements
    elif isinstance(obj, (int, float)) and math.isfinite(obj):
        out[prefix] = float(obj)
    elif (shapes is not None and isinstance(obj, str)
          and prefix.endswith("_shape")):
        shapes[prefix] = obj


def load_round(path) -> Optional[BenchRound]:
    """Parse one ``BENCH_*.json`` (an archive wrapper with a ``parsed``
    payload, or a bare ``{metric, value, extra}`` line). None when the
    file holds no usable payload — the sentinel skips, not crashes, on a
    foreign file."""
    path = Path(path)
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    payload = doc.get("parsed", doc) if isinstance(doc, dict) else None
    if not isinstance(payload, dict) or "metric" not in payload:
        return None
    n = doc.get("n") if isinstance(doc, dict) else None
    if n is None:
        m = _ROUND_RE.search(path.stem)
        n = int(m.group(1)) if m else 10**9
    values: Dict[str, float] = {}
    shapes: Dict[str, str] = {}
    disabled: Dict[str, str] = {}
    _flatten("", payload.get("extra") or {}, values, shapes, disabled)
    value = payload.get("value")
    metric = str(payload["metric"])
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        values[metric] = float(value)
    device = (payload.get("extra") or {}).get("device")
    return BenchRound(
        label=path.stem,
        order=(int(n), path.name),
        metric=metric,
        value=float(value) if isinstance(value, (int, float)) else float("nan"),
        values=values,
        shapes=shapes,
        device=str(device) if isinstance(device, str) else None,
        disabled=disabled,
    )


def load_rounds(paths: Sequence) -> List[BenchRound]:
    """Parse + chronologically order the rounds (the wrapper's ``n``, falling
    back to the ``rNN`` in the filename)."""
    rounds = [r for r in (load_round(p) for p in paths) if r is not None]
    rounds.sort(key=lambda r: r.order)
    return rounds


def direction(key: str) -> Optional[str]:
    """"lower" / "higher" is-better, or None for untracked series."""
    key = key.split("@", 1)[0]  # drop the shape qualifier (_series_key)
    leaf = key.rsplit(".", 1)[-1]
    if (
        leaf.endswith("_qps")
        or "speedup" in leaf
        or leaf.endswith("_per_s")  # rows_per_s, cells_per_s, ... throughput
        or leaf.endswith("_utilization")  # roofline gauges (kernels ladder)
        or leaf.endswith("_over_thread")  # fleet process/thread ratio
        or leaf == "vs_baseline"
    ):
        return "higher"
    if "." in key:
        # nested breakdowns (per-stage seconds, cache-probe fields) are
        # ATTRIBUTION, not objectives: stage-accounting fixes legitimately
        # move seconds between stages while the total improves, so gating
        # them would manufacture regressions
        return None
    if "compile" in leaf:
        # compile wall time swings with persistent-cache state (a fresh
        # CI machine pays full compiles a warmed one doesn't) — report,
        # never gate
        return None
    if leaf.endswith(("_s", "_ms", "_mb", "_bytes", "_pct")):
        return "lower"
    return None


def _series_key(key: str, shapes: Dict[str, str],
                device: Optional[str]) -> str:
    """Qualify a metric by its section's ``*_shape`` disclosure and the
    round's device platform.

    A series is only a series when it measures the same thing: a section
    that resizes (env overrides, new defaults) or a round on different
    hardware produces numbers that are NOT comparable with the history —
    gating a round on one platform against another platform's best would
    manufacture a "regression" out of a platform change. Every bench
    section discloses its size as
    ``<section>_shape`` and every round its ``device``; the series key
    appends both (``kernel_fm_boot_warm_s@T720_N6000_B10000@cpu``), so
    same-shape/same-device history gates and everything else separates.
    Metrics without a shape sibling and rounds predating the disclosures
    keep the bare pieces."""
    best = ""
    for sk in shapes:
        prefix = sk[: -len("shape")]
        if key.startswith(prefix) and len(prefix) > len(best):
            best = sk
    if best:
        key = f"{key}@{shapes[best]}"
    if device:
        key = f"{key}@{device}"
    return key


def build_series(rounds: Sequence[BenchRound]) -> Dict[str, List[Tuple[str, float]]]:
    """series key → [(round label, value)] in round order. Keys are
    shape/device-qualified via :func:`_series_key`."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    for r in rounds:
        for key, v in r.values.items():
            out.setdefault(_series_key(key, r.shapes, r.device), []).append(
                (r.label, v)
            )
    return out


@dataclasses.dataclass(frozen=True)
class MetricVerdict:
    key: str
    status: str  # one of STATUSES
    latest: Optional[float]
    baseline: Optional[float]  # direction-adjusted best of history
    band_ratio: Optional[float]  # worse-than-baseline ratio that gates
    direction: Optional[str]
    history: Tuple[Tuple[str, float], ...]
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RegressionReport:
    rounds: Tuple[str, ...]
    latest: str
    verdicts: Tuple[MetricVerdict, ...]
    # latest round's deliberately-disabled sections: (section, why) —
    # disclosure only; nothing under a disabled section ever gates
    disabled: Tuple[Tuple[str, str], ...] = ()

    def by_status(self, status: str) -> List[MetricVerdict]:
        return [v for v in self.verdicts if v.status == status]

    @property
    def regressions(self) -> List[MetricVerdict]:
        return self.by_status("regressed")

    @property
    def ok(self) -> bool:
        return not self.regressions

    def to_json(self) -> dict:
        return {
            "schema": 1,
            "rounds": list(self.rounds),
            "latest": self.latest,
            "ok": self.ok,
            "counts": {s: len(self.by_status(s)) for s in STATUSES},
            "disabled": {k: v for k, v in self.disabled},
            "verdicts": [v.to_json() for v in self.verdicts],
        }

    def format_text(self, verbose: bool = False) -> str:
        lines = [
            f"perf-regression sentinel: {len(self.rounds)} rounds "
            f"({', '.join(self.rounds)}), latest {self.latest}"
        ]
        counts = {s: len(self.by_status(s)) for s in STATUSES}
        lines.append(
            "  " + "  ".join(f"{s}={n}" for s, n in counts.items() if n)
        )
        for section, why in self.disabled:
            lines.append(
                f"  - disabled  {section}: {why} (disclosed, never gated)"
            )
        show = {"regressed", "improved"} | ({"ok", "new", "missing", "skipped"}
                                            if verbose else set())
        for v in self.verdicts:
            if v.status not in show:
                continue
            arrow = {"regressed": "✗", "improved": "✓"}.get(v.status, "·")
            hist = " -> ".join(f"{x:.4g}" for _, x in v.history)
            extra = f" [{v.note}]" if v.note else ""
            lines.append(
                f"  {arrow} {v.status:<9s} {v.key}: {hist}{extra}"
            )
        if self.ok:
            lines.append("  PASS: no perf regressions beyond noise bands")
        else:
            lines.append(
                f"  FAIL: {counts['regressed']} metric(s) regressed "
                "beyond their fitted noise band"
            )
        return "\n".join(lines)


def _noise_band(history_vals: Sequence[float], dirn: str,
                floor_rel: float, k: float) -> float:
    """Worse-than-best ratio that gates: fitted from the magnitudes of
    the WORSENING consecutive steps in the history (log space), floored
    at ``floor_rel``."""
    worsening: List[float] = []
    for prev, cur in zip(history_vals, history_vals[1:]):
        if prev <= 0 or cur <= 0:
            continue
        step = math.log(cur / prev)
        if dirn == "higher":
            step = -step
        if step > 0:  # got worse — that fluctuation is the noise floor
            worsening.append(step)
    fitted = statistics.median(worsening) if worsening else 0.0
    return math.exp(max(math.log1p(floor_rel), k * fitted))


def analyze(
    rounds: Sequence[BenchRound],
    floor_rel: float = 0.25,
    k: float = 1.5,
    abs_floor: float = 0.05,
) -> RegressionReport:
    """Fit per-metric noise bands over all-but-the-latest round and judge
    the latest. See the module docstring for the model; ``k`` scales the
    fitted worsening-step noise, ``abs_floor`` suppresses regressions
    smaller than that in the metric's own units."""
    if not rounds:
        raise ValueError("no bench rounds to analyze")
    latest = rounds[-1]
    series = build_series(rounds)
    verdicts: List[MetricVerdict] = []

    def _disabled_why(key: str) -> Optional[str]:
        bare = key.split("@", 1)[0]
        for section, why in latest.disabled.items():
            if bare == section or bare.startswith((f"{section}.",
                                                   f"{section}_")):
                return why
        return None

    for key in sorted(series):
        points = series[key]
        history = tuple(points)
        dirn = direction(key)
        in_latest = points and points[-1][0] == latest.label
        prior = [v for label, v in points if label != latest.label]
        if dirn is None:
            verdicts.append(MetricVerdict(
                key, "skipped", points[-1][1] if in_latest else None,
                None, None, None, history, note="untracked (no direction)",
            ))
            continue
        if not in_latest:
            why = _disabled_why(key)
            if why is not None:
                # its section is explicitly disabled in the latest
                # round: disclosed absence, never a "missing" finding
                verdicts.append(MetricVerdict(
                    key, "skipped", None, None, None, dirn, history,
                    note=f"section disabled: {why}",
                ))
                continue
            verdicts.append(MetricVerdict(
                key, "missing", None,
                (min(prior) if dirn == "lower" else max(prior)) if prior else None,
                None, dirn, history,
                note="present in history, absent in latest round",
            ))
            continue
        latest_v = points[-1][1]
        if not prior:
            verdicts.append(MetricVerdict(
                key, "new", latest_v, None, None, dirn, history,
                note="first appearance",
            ))
            continue
        if latest_v <= 0 or any(v <= 0 for v in prior):
            verdicts.append(MetricVerdict(
                key, "skipped", latest_v, None, None, dirn, history,
                note="non-positive values; ratio bands undefined",
            ))
            continue
        best = min(prior) if dirn == "lower" else max(prior)
        band = _noise_band(prior, dirn, floor_rel, k)
        worse_ratio = (latest_v / best) if dirn == "lower" else (best / latest_v)
        if worse_ratio < 1.0:
            status, note = "improved", f"new best (prev {best:.4g})"
        elif worse_ratio > band and abs(latest_v - best) > abs_floor:
            status = "regressed"
            note = (f"{worse_ratio:.2f}x worse than best {best:.4g} "
                    f"(band {band:.2f}x)")
        else:
            status, note = "ok", f"within {band:.2f}x band of best {best:.4g}"
        verdicts.append(MetricVerdict(
            key, status, latest_v, best, round(band, 4), dirn, history,
            note=note,
        ))
    order = {s: i for i, s in enumerate(STATUSES)}
    verdicts.sort(key=lambda v: (order[v.status], v.key))
    return RegressionReport(
        rounds=tuple(r.label for r in rounds),
        latest=latest.label,
        verdicts=tuple(verdicts),
        disabled=tuple(sorted(latest.disabled.items())),
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m fm_returnprediction_tpu_torch.telemetry.regress",
        description="Perf-regression sentinel over BENCH_*.json history.",
    )
    parser.add_argument(
        "files", nargs="*",
        help="bench artifacts in any order (default: ./BENCH_*.json)",
    )
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON on stdout")
    parser.add_argument("--verbose", action="store_true",
                        help="also list ok/new/missing/skipped verdicts")
    parser.add_argument("--no-fail", action="store_true",
                        help="always exit 0 (report-only mode)")
    parser.add_argument("--floor-rel", type=float, default=0.25,
                        help="minimum relative noise band (default 0.25)")
    parser.add_argument("--abs-floor", type=float, default=0.05,
                        help="minimum absolute move to count (default 0.05)")
    args = parser.parse_args(argv)

    files = args.files or sorted(_glob.glob("BENCH_*.json"))
    rounds = load_rounds(files)
    if len(rounds) < 2:
        print(
            f"regress: need >=2 parseable bench rounds, got {len(rounds)} "
            f"from {len(files)} file(s) — nothing to gate",
            file=sys.stderr,
        )
        return 0
    report = analyze(rounds, floor_rel=args.floor_rel,
                     abs_floor=args.abs_floor)
    if args.json:
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        print(report.format_text(verbose=args.verbose))
    if not report.ok and not args.no_fail:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
