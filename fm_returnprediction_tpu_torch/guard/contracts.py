"""Declarative invariant contracts at the pipeline's stage boundaries.

The tripwire for failures that stay silent — a duplicated permno, a
non-monotone calendar, a NaN-flooded table, a characteristic scaled into
f32-overflow territory — which would otherwise flow straight into Table 2's
t-stats. A contract is a named :class:`Rule` with a declared severity,
evaluated against a stage's product:

- ``fail``       → raise :class:`ContractViolationError` (the data is wrong
  and every downstream number would be too);
- ``quarantine`` → the optional artifact is dropped and the run continues
  degraded (:func:`screen_artifact`);
- ``warn``       → :class:`GuardWarning` + an audit entry (the invariant
  is a convention, not a correctness requirement — e.g. a coherently
  permuted firm vocabulary changes no statistic).

Evaluation short-circuits at the first ``fail``/``quarantine`` violation
(later rules may assume the earlier invariant); ``warn`` violations collect
and evaluation continues. Every violation lands in the run's
:class:`AuditRecord`, which also absorbs the numerical sentinel counters
(``guard.checks``).

The panel contract reduces the (T, N, K) panel on its own device
(:func:`panel_probe`): a handful of torch reductions, then ONE copy of the
small per-column vectors to the host — the panel itself never crosses. The
probe doubles as the drift sentinel's panel summary (``guard.drift``).
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fm_returnprediction_tpu_torch.resilience.errors import (
    ContractViolationError,
    IngestRejectedError,
)

__all__ = [
    "GuardWarning",
    "Violation",
    "Rule",
    "AuditRecord",
    "evaluate",
    "enforce",
    "screen_artifact",
    "panel_probe",
    "panel_rules",
    "check_panel",
    "frame_rules",
    "check_frame",
    "backtest_rules",
    "cross_section_rules",
    "serving_state_rules",
    "VALUE_BOUND",
]

SEVERITIES = ("fail", "quarantine", "warn")

# |characteristic| beyond this is treated as corruption, not data: nothing
# in the panel (log-scales, ratios, returns, raw $M market equity) comes
# within orders of magnitude, while values past ~1.8e19 overflow an f32
# Gram contraction (x² > f32 max 3.4e38).
VALUE_BOUND = 1e15


class GuardWarning(UserWarning):
    """A warn-severity contract violation (recorded, never raised)."""


@dataclasses.dataclass(frozen=True)
class Violation:
    """One named contract breach: which rule, how bad, what it saw."""

    rule: str
    severity: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """A named invariant with a declared severity.

    ``check(subject)`` returns ``None`` when the invariant holds, else a
    human-readable detail string. A check that CRASHES is itself reported
    as a violation at the rule's severity."""

    name: str
    severity: str
    check: Callable[[object], Optional[str]]

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity for {self.name!r} must be one of {SEVERITIES}, "
                f"got {self.severity!r}"
            )


@dataclasses.dataclass
class AuditRecord:
    """The run-level guard ledger: contract violations, numerical sentinel
    counters, and artifacts quarantined. Attached to
    ``PipelineResult.audit`` and serialized into the drift manifest."""

    violations: List[Violation] = dataclasses.field(default_factory=list)
    counters: Counter = dataclasses.field(default_factory=Counter)
    quarantined: List[str] = dataclasses.field(default_factory=list)

    def record(self, violations: Sequence[Violation]) -> None:
        self.violations.extend(violations)

    def record_counters(self, counts: Dict[str, int]) -> None:
        for name, count in counts.items():
            if count:
                self.counters[name] += int(count)

    def names(self) -> List[str]:
        return [v.rule for v in self.violations]

    def ok(self) -> bool:
        return not self.violations and not self.counters

    def as_dict(self) -> dict:
        return {
            "violations": [dataclasses.asdict(v) for v in self.violations],
            "counters": dict(self.counters),
            "quarantined": list(self.quarantined),
        }

    def report(self) -> str:
        lines = [str(v) for v in self.violations]
        lines += [f"[counter] {k} = {v}" for k, v in sorted(self.counters.items())]
        lines += [f"[quarantined] {name}" for name in self.quarantined]
        return "\n".join(lines) if lines else "guards: clean"


def evaluate(rules: Sequence[Rule], subject) -> List[Violation]:
    """Run the rules in order against ``subject``. Short-circuits after the
    first blocking (``fail``/``quarantine``) violation; ``warn`` findings
    accumulate and evaluation continues."""
    out: List[Violation] = []
    for rule in rules:
        try:
            detail = rule.check(subject)
        except Exception as exc:  # noqa: BLE001 — a crashed check IS a finding
            detail = f"contract check crashed: {exc!r}"
        if detail:
            out.append(Violation(rule.name, rule.severity, str(detail)))
            if rule.severity != "warn":
                break
    return out


def enforce(
    violations: Sequence[Violation],
    audit: Optional[AuditRecord] = None,
    context: str = "",
) -> List[Violation]:
    """Apply the severity ladder: record everything, warn the warns, raise
    the worst blocking severity (``fail`` → :class:`ContractViolationError`,
    ``quarantine`` → :class:`IngestRejectedError`)."""
    violations = list(violations)
    if audit is not None:
        audit.record(violations)
    for v in violations:
        if v.severity == "warn":
            warnings.warn(GuardWarning(str(v)), stacklevel=2)
    prefix = f"{context}: " if context else ""
    fails = [v for v in violations if v.severity == "fail"]
    if fails:
        raise ContractViolationError(prefix + "; ".join(str(v) for v in fails))
    quars = [v for v in violations if v.severity == "quarantine"]
    if quars:
        raise IngestRejectedError(prefix + "; ".join(str(v) for v in quars))
    return violations


def screen_artifact(
    name: str,
    artifact,
    rules: Sequence[Rule],
    audit: Optional[AuditRecord] = None,
):
    """Contract gate for an OPTIONAL pipeline artifact: on a
    quarantine-severity violation the artifact is dropped (returns ``None``)
    and the run continues degraded; ``fail`` still raises."""
    if artifact is None:
        return None
    violations = evaluate(rules, artifact)
    try:
        enforce(violations, audit=audit, context=name)
    except IngestRejectedError as exc:
        if audit is not None:
            audit.quarantined.append(name)
        warnings.warn(
            GuardWarning(f"artifact {name!r} quarantined: {exc}"), stacklevel=2
        )
        return None
    return artifact


# -- panel contracts -------------------------------------------------------


def numpy_dtype(a) -> np.dtype:
    """The numpy dtype of an array, a torch tensor, a torch dtype or a
    numpy dtype or scalar type (the contracts and the fingerprints speak
    numpy's dtype vocabulary)."""
    if isinstance(a, torch.Tensor):
        a = a.dtype
    if isinstance(a, torch.dtype):
        return torch.empty((), dtype=a).numpy().dtype
    if isinstance(a, (type, np.dtype, str)):
        return np.dtype(a)
    return np.dtype(a.dtype)


def panel_probe(panel) -> dict:
    """The per-column finite counts, moments and extrema and the per-month
    mask counts of the (T, N, K) panel, reduced on the panel's device and
    brought to the host in one copy of the small vectors."""
    values = torch.as_tensor(panel.values)
    t, n, k = (int(s) for s in values.shape)
    finite = torch.isfinite(values)
    vz = torch.where(finite, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))
    summary = torch.stack([
        finite.sum(dim=(0, 1)).to(torch.float64),
        torch.isinf(values).sum(dim=(0, 1)).to(torch.float64),
        vz.sum(dim=(0, 1)).to(torch.float64),
        (vz * vz).sum(dim=(0, 1)).to(torch.float64),
        torch.where(finite, values, float("inf")).amin(dim=(0, 1)).to(torch.float64),
        torch.where(finite, values, float("-inf")).amax(dim=(0, 1)).to(torch.float64),
    ])
    del finite, vz
    # a copy: the mask may be a read-only map of a prepared-inputs slot
    mask_counts = torch.tensor(np.asarray(panel.mask)).sum(dim=1)
    cnt, inf_cnt, total, total2, vmin, vmax = summary.cpu().numpy()
    mask_counts = mask_counts.numpy()
    cnt = cnt.astype(np.int64)
    safe = np.maximum(cnt, 1).astype(np.float64)
    mean = total / safe
    var = np.maximum(total2 / safe - mean * mean, 0.0)
    columns = {}
    for j, name in enumerate(panel.var_names):
        columns[str(name)] = {
            "finite": int(cnt[j]),
            "inf": int(inf_cnt[j]),
            "mean": float(mean[j]) if cnt[j] else None,
            "std": float(np.sqrt(var[j])) if cnt[j] else None,
            "min": float(vmin[j]) if cnt[j] else None,
            "max": float(vmax[j]) if cnt[j] else None,
        }
    return {
        "kind": "panel",
        "shape": [t, n, k],
        "dtype": str(numpy_dtype(values)),
        "mask_total": int(mask_counts.sum()),
        "mask_min_month": int(mask_counts.min()) if t else 0,
        "columns": columns,
    }


def panel_rules(
    dtype=None,
    value_bound: float = VALUE_BOUND,
    return_col: str = "retx",
    ret_high: float = 30.0,
) -> List[Rule]:
    """The dense-panel stage-boundary contract. Subject: ``(panel, probe)``
    — a ``DensePanel`` plus its :func:`panel_probe` summary. ``dtype`` (a
    torch or numpy dtype) pins the values' dtype."""

    def _schema(sub):
        panel, probe = sub
        t, n, k = probe["shape"]
        if panel.values.ndim != 3:
            return f"values must be (T, N, K), got ndim {panel.values.ndim}"
        if tuple(np.shape(panel.mask)) != (t, n):
            return f"mask shape {tuple(np.shape(panel.mask))} != (T, N) = {(t, n)}"
        if len(panel.months) != t or len(panel.ids) != n:
            return (
                f"axis vocabularies disagree with values: months "
                f"{len(panel.months)} vs T={t}, ids {len(panel.ids)} vs N={n}"
            )
        if len(panel.var_names) != k:
            return f"{len(panel.var_names)} var_names for K={k} columns"
        if not np.issubdtype(numpy_dtype(panel.values), np.floating):
            return f"values dtype {numpy_dtype(panel.values)} is not floating"
        return None

    def _dtype(sub):
        panel, _ = sub
        if dtype is None:
            return None
        got, want = numpy_dtype(panel.values), numpy_dtype(dtype)
        if got != want:
            return f"values dtype {got} != configured {want}"
        return None

    def _calendar(sub):
        panel, _ = sub
        months = np.asarray(panel.months).astype("datetime64[ns]")
        if len(months) > 1 and not (np.diff(months.astype(np.int64)) > 0).all():
            bad = int(np.argmin(np.diff(months.astype(np.int64)) > 0))
            return (
                f"months are not strictly increasing at index {bad + 1} "
                f"({months[bad]} -> {months[bad + 1]}): a stale or "
                f"duplicated month entered the calendar"
            )
        return None

    def _key_unique(sub):
        panel, _ = sub
        ids = np.asarray(panel.ids)
        if len(np.unique(ids)) != len(ids):
            uniq, counts = np.unique(ids, return_counts=True)
            dups = uniq[counts > 1][:5]
            return (
                f"{len(ids) - len(np.unique(ids))} duplicated firm id(s) "
                f"(permno appears twice in one month's cross-section): "
                f"e.g. {list(dups)!r}"
            )
        return None

    def _ids_sorted(sub):
        panel, _ = sub
        ids = np.asarray(panel.ids)
        if len(ids) > 1 and not (ids[:-1] <= ids[1:]).all():
            return (
                "firm vocabulary is not sorted (the long_to_dense contract): "
                "the firm axis was permuted — statistics are unaffected by a "
                "coherent relabeling, but positional consumers (serving "
                "states, cached masks) must not mix vocabularies"
            )
        return None

    def _mask_sanity(sub):
        panel, probe = sub
        if numpy_dtype(panel.mask) != np.bool_:
            return f"mask dtype {numpy_dtype(panel.mask)} is not bool"
        if probe["mask_total"] == 0:
            return "mask is empty: no firm-month exists anywhere"
        if probe["mask_min_month"] == 0:
            return (
                "a month has zero existing rows — the month vocabulary is "
                "derived from observed rows, so an empty month means a "
                "corrupted calendar or mask"
            )
        return None

    def _value_bounds(sub):
        _, probe = sub
        # literal ±inf entries are ALREADY-overflowed values, not missing
        # data — the finite-moment scan would never see them
        infected = {
            name: col["inf"]
            for name, col in probe["columns"].items() if col.get("inf")
        }
        if infected:
            return (
                f"infinite entries in {sorted(infected)} (counts "
                f"{infected}): already-overflowed or divide-by-zero values"
            )
        offenders = {
            name: col["max"] if abs(col["max"] or 0) >= abs(col["min"] or 0)
            else col["min"]
            for name, col in probe["columns"].items()
            if col["finite"]
            and max(abs(col["min"]), abs(col["max"])) > value_bound
        }
        if offenders:
            return (
                f"|value| exceeds the guard bound {value_bound:g} in "
                f"{sorted(offenders)} (worst: {offenders}); magnitudes this "
                f"large overflow an f32 Gram contraction"
            )
        return None

    def _return_bounds_low(sub):
        _, probe = sub
        col = probe["columns"].get(return_col)
        if col and col["finite"] and col["min"] is not None and col["min"] < -1.0 - 1e-9:
            return (
                f"{return_col} has a return below -100% (min "
                f"{col['min']:.6g}): impossible for a simple return — "
                f"corrupted data"
            )
        return None

    def _return_bounds_high(sub):
        _, probe = sub
        col = probe["columns"].get(return_col)
        if col and col["finite"] and col["max"] is not None and col["max"] > ret_high:
            return (
                f"{return_col} max {col['max']:.6g} exceeds the plausibility "
                f"bound {ret_high:g} ({ret_high:.0%})"
            )
        return None

    def _nan_budget(sub):
        _, probe = sub
        dead = [n for n, c in probe["columns"].items() if c["finite"] == 0]
        if dead:
            return (
                f"{len(dead)} all-NaN column(s): {sorted(dead)} — every "
                f"downstream regression silently drops them"
            )
        return None

    return [
        Rule("panel.schema", "fail", _schema),
        Rule("panel.dtype", "fail", _dtype),
        Rule("panel.calendar_monotone", "fail", _calendar),
        Rule("panel.key_unique", "fail", _key_unique),
        Rule("panel.ids_sorted", "warn", _ids_sorted),
        Rule("panel.mask_sanity", "fail", _mask_sanity),
        Rule("panel.value_bounds", "fail", _value_bounds),
        Rule("panel.return_bounds_low", "fail", _return_bounds_low),
        Rule("panel.return_bounds_high", "warn", _return_bounds_high),
        Rule("panel.nan_budget", "warn", _nan_budget),
    ]


def check_panel(
    panel,
    dtype=None,
    audit: Optional[AuditRecord] = None,
    context: str = "panel",
    probe: Optional[dict] = None,
) -> dict:
    """Probe + evaluate + enforce the panel contract; returns the probe
    (reused by the drift sentinel as the ``panel_stats`` summary). A panel
    the probe cannot even reduce (wrong rank, mismatched axes) is itself a
    schema violation, raised as the typed ``ContractViolationError``."""
    if probe is None:
        try:
            probe = panel_probe(panel)
        except Exception as exc:  # noqa: BLE001 — unreadable IS the finding
            violation = Violation(
                "panel.schema", "fail",
                f"panel is structurally unreadable by the probe: {exc!r}",
            )
            if audit is not None:
                audit.record([violation])
            raise ContractViolationError(f"{context}: {violation}") from exc
    enforce(evaluate(panel_rules(dtype=dtype), (panel, probe)),
            audit=audit, context=context)
    return probe


# -- report-frame contracts ------------------------------------------------


def frame_rules(name: str, blocking: str = "fail") -> List[Rule]:
    """Stage-boundary contract for a reporting DataFrame (numeric frames
    and the formatted string tables alike — values are coerced).
    ``blocking`` is the severity of the structural rules: ``"fail"`` for
    Table 1/2, ``"quarantine"`` for optional artifacts."""

    def _coerce(df):
        import pandas as pd

        return df.apply(pd.to_numeric, errors="coerce")

    def _nonempty(df):
        if df is None or df.shape[0] == 0 or df.shape[1] == 0:
            shape = None if df is None else df.shape
            return f"frame is empty (shape {shape})"
        return None

    def _not_flooded(df):
        num = _coerce(df)
        if num.size and not np.isfinite(num.to_numpy(dtype=float)).any():
            return "no finite value anywhere in the frame"
        return None

    def _dead_columns(df):
        num = _coerce(df)
        vals = num.to_numpy(dtype=float)
        if not vals.size:
            return None
        dead = [
            str(col) for col, finite in
            zip(num.columns, np.isfinite(vals).any(axis=0))
            if not finite
        ]
        # the formatted Table 2 legitimately carries all-blank R²/t-stat
        # sub-columns on N rows; flag only a majority-dead frame
        if dead and len(dead) > num.shape[1] // 2:
            return f"{len(dead)}/{num.shape[1]} columns have no finite value"
        return None

    return [
        Rule(f"{name}.nonempty", blocking, _nonempty),
        Rule(f"{name}.nonfinite_flood", blocking, _not_flooded),
        Rule(f"{name}.dead_columns", "warn", _dead_columns),
    ]


def check_frame(frame, name: str, audit: Optional[AuditRecord] = None) -> None:
    enforce(evaluate(frame_rules(name), frame), audit=audit, context=name)


def backtest_rules(blocking: str = "quarantine") -> List[Rule]:
    """Stage-boundary contract for the backtest cell frame: the generic
    frame rules plus the metric ranges the backtest schema promises — the
    required per-cell columns exist, a finite ``oos_r2`` never exceeds 1,
    ICs are correlations in [−1, 1], and one-way turnover of a normalized
    long-short book lies in [0, 1]."""
    required = ("cell", "scheme", "set", "universe", "weighting", "oos_r2", "ic_mean",
                "spread", "spread_tstat", "spread_turnover", "n_months")

    def _has_columns(df):
        missing = [c for c in required if c not in df.columns]
        if missing:
            return f"backtest frame lacks required columns {missing}"
        return None

    def _in_band(col, lo, hi):
        def check(df):
            if col not in df.columns:  # presence is _has_columns's call
                return None
            vals = np.asarray(df[col], dtype=float)
            vals = vals[np.isfinite(vals)]
            if vals.size and ((vals < lo).any() or (vals > hi).any()):
                return (f"{col} outside [{lo}, {hi}]: "
                        f"range [{vals.min():.4g}, {vals.max():.4g}]")
            return None

        return check

    return frame_rules("backtest", blocking) + [
        Rule("backtest.columns", blocking, _has_columns),
        Rule("backtest.oos_r2_bound", blocking, _in_band("oos_r2", -np.inf, 1.0)),
        Rule("backtest.ic_band", blocking, _in_band("ic_mean", -1.0, 1.0)),
        Rule("backtest.rank_ic_band", blocking, _in_band("rank_ic_mean", -1.0, 1.0)),
        Rule("backtest.turnover_band", blocking, _in_band("spread_turnover", 0.0, 1.0)),
    ]


# -- serving cross-section contracts ---------------------------------------


def cross_section_rules(
    state, month=None, value_bound: float = VALUE_BOUND
) -> List[Rule]:
    """The one definition of a valid ingest cross-section
    (``serving.ingest.validate_cross_section`` is a thin wrapper). Subject:
    the coerced numpy ``(y, x, mask)`` triple.

    All severities are ``quarantine``: keeping the last good state and
    ledgering the month is the right blast radius for one bad month."""

    def _shape(sub):
        _, x, _ = sub
        if x.ndim != 2:
            return f"x must be (N, P), got shape {x.shape}"
        if x.shape[-1] != state.n_predictors:
            return (
                f"expected {state.n_predictors} predictors ({state.xvars}), "
                f"got {x.shape[-1]}"
            )
        return None

    def _length(sub):
        y, x, mask = sub
        if not (y.shape == mask.shape == x.shape[:1]):
            return f"length mismatch: y {y.shape}, x {x.shape}, mask {mask.shape}"
        return None

    def _nan_flood(sub):
        y, x, mask = sub
        if mask.any() and not np.isfinite(x[mask]).any():
            return "all-NaN cross-section: no finite predictor in any masked row"
        return None

    def _y_bounds(sub):
        y, x, mask = sub
        if mask.any() and np.isinf(y[mask]).any():
            return "infinite realized return in y"
        return None

    def _value_bounds(sub):
        y, x, mask = sub
        if not mask.any():
            return None
        xm = x[mask]
        finite = np.isfinite(xm)
        if finite.any():
            worst = float(np.abs(np.where(finite, xm, 0.0)).max())
            if worst > value_bound:
                return (
                    f"predictor magnitude {worst:.3g} exceeds the guard "
                    f"bound {value_bound:g} (f32 Gram overflow territory)"
                )
        return None

    def _stale_repeat(sub):
        if month is None or state.n_months == 0:
            return None
        stamp = np.datetime64(month, "ns")
        if stamp == state.months[-1]:
            return None  # a merge re-offer of the same month is legal
        y, x, mask = sub
        from fm_returnprediction_tpu_torch.serving.state import _support_bounds

        lo, hi = _support_bounds(torch.from_numpy(np.asarray(x)[None]),
                                 torch.from_numpy(np.asarray(mask, dtype=bool)[None]))
        lo, hi = lo[0].numpy(), hi[0].numpy()
        if not (np.isfinite(lo).any() or np.isfinite(hi).any()):
            return None  # an empty/thin month carries no repeat evidence
        if np.array_equal(lo, state.x_lo[-1]) and np.array_equal(hi, state.x_hi[-1]):
            return (
                f"stale repeated month: the cross-section offered as "
                f"{stamp} is bit-identical (per-column support bounds) to "
                f"the state's last month {state.months[-1]} — the upstream "
                f"feed looks stuck"
            )
        return None

    return [
        Rule("cs.shape", "quarantine", _shape),
        Rule("cs.length", "quarantine", _length),
        Rule("cs.nan_flood", "quarantine", _nan_flood),
        Rule("cs.y_bounds", "quarantine", _y_bounds),
        Rule("cs.value_bounds", "quarantine", _value_bounds),
        Rule("cs.stale_repeat", "quarantine", _stale_repeat),
    ]


# -- serving-state contracts -----------------------------------------------


def serving_state_rules() -> List[Rule]:
    """Sanity contract over a fitted ``ServingState`` before it is
    persisted. Quarantine severity: a pipeline run can complete (degraded)
    without its serving artifact."""

    def _schema(st):
        t, q = st.coef.shape
        p = st.n_predictors
        if q != p + 1:
            return f"coef width {q} != n_predictors + 1 = {p + 1}"
        bad = [
            name for name, arr, shape in (
                ("months", st.months, (t,)),
                ("month_valid", st.month_valid, (t,)),
                ("slopes_bar", st.slopes_bar, (t, p)),
                ("intercept_bar", st.intercept_bar, (t,)),
                ("x_lo", st.x_lo, (t, p)),
                ("x_hi", st.x_hi, (t, p)),
                ("gram", st.gram, (t, q, q)),
                ("moment", st.moment, (t, q)),
                ("n_obs", st.n_obs, (t,)),
            ) if tuple(np.shape(arr)) != shape
        ]
        if bad:
            return f"leaf shapes inconsistent with T={t}, P={p}: {bad}"
        return None

    def _calendar(st):
        if st.n_months > 1:
            stamps = st.months.astype("datetime64[ns]").astype(np.int64)
            if not (np.diff(stamps) > 0).all():
                return "state months are not strictly increasing"
        return None

    def _stats_finite(st):
        bad = int((~np.isfinite(st.gram)).sum() + (~np.isfinite(st.moment)).sum())
        if bad:
            return (
                f"{bad} non-finite sufficient-statistic entries: a poisoned "
                f"or overflowed month is baked into the state"
            )
        return None

    def _window(st):
        if st.window <= 0 or st.min_periods <= 0 or st.min_periods > st.window:
            return (
                f"window/min_periods ({st.window}/{st.min_periods}) are not "
                f"a valid rolling configuration"
            )
        return None

    return [
        Rule("serving_state.schema", "quarantine", _schema),
        Rule("serving_state.calendar_monotone", "quarantine", _calendar),
        Rule("serving_state.stats_finite", "quarantine", _stats_finite),
        Rule("serving_state.window", "quarantine", _window),
    ]
