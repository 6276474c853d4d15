"""Drift sentinels: tolerance-banded artifact comparison across runs.

A code or data change that silently moves Table 2's slopes is invisible to
the contract layer (the new numbers are well-formed). The drift sentinel
closes that gap: each guarded run summarizes its artifacts — the dense
panel's stats, the tables, the decile table, the serving state — into an
AUDIT MANIFEST (``audit.json`` under ``--audit-dir``): a content sha256
plus per-column summary moments (finite count, mean, std, min, max). The
next run with the SAME data fingerprint compares itself against it:

- sha256 equal → bit-identical artifact, pass with no moment math;
- else every (column, moment) must sit inside the tolerance band
  ``|cur − prev| ≤ atol + rtol · max(|prev|, |cur|)`` — any breach fails
  loudly (:class:`DriftDetectedError`) with a per-column report, and the
  TRUSTED manifest is left unmodified;
- a different fingerprint (new data, other dtype, resized universe) makes
  comparison meaningless: the sentinel re-baselines.

The manifest format is the reference package's, so a manifest written by
either package is read by the other's sentinel for the same panel. Band
defaults ``DriftBand(rtol=1e-3, atol=1e-6)``; override per artifact via
``band=`` or globally via ``FMRP_DRIFT_RTOL``/``FMRP_DRIFT_ATOL``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from fm_returnprediction_tpu_torch.guard.contracts import AuditRecord, Violation
from fm_returnprediction_tpu_torch.resilience.errors import DriftDetectedError
from fm_returnprediction_tpu_torch.registry.integrity import array_bundle_digest

__all__ = [
    "DriftBand",
    "DriftSentinel",
    "summarize_frame",
    "summarize_arrays",
    "compare_summaries",
    "MANIFEST_NAME",
]

MANIFEST_NAME = "audit.json"
_MOMENTS = ("mean", "std", "min", "max")


@dataclasses.dataclass(frozen=True)
class DriftBand:
    """Per-moment tolerance: ``|cur − prev| ≤ atol + rtol·max(|prev|,|cur|)``.
    The env defaults resolve at instantiation, so ``FMRP_DRIFT_RTOL`` and
    ``FMRP_DRIFT_ATOL`` set after import still take effect."""

    rtol: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get("FMRP_DRIFT_RTOL", "1e-3"))
    )
    atol: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get("FMRP_DRIFT_ATOL", "1e-6"))
    )

    def holds(self, prev: float, cur: float) -> bool:
        if prev is None or cur is None:
            return prev is None and cur is None
        if np.isnan(prev) and np.isnan(cur):
            return True
        return abs(cur - prev) <= self.atol + self.rtol * max(abs(prev), abs(cur))


def _column_summary(arr: np.ndarray) -> dict:
    arr = np.asarray(arr, dtype=np.float64).ravel()
    finite = np.isfinite(arr)
    n = int(finite.sum())
    vals = arr[finite]
    return {
        "finite": n,
        "size": int(arr.size),
        "mean": float(vals.mean()) if n else None,
        "std": float(vals.std()) if n else None,
        "min": float(vals.min()) if n else None,
        "max": float(vals.max()) if n else None,
    }


def summarize_frame(df) -> dict:
    """Summary of a reporting frame: per-column moments over the NUMERIC
    view (formatted string tables coerce — blanks become NaN) + a content
    sha256 over the coerced values and the axis labels."""
    import pandas as pd

    num = df.apply(pd.to_numeric, errors="coerce")
    vals = num.to_numpy(dtype=np.float64)
    h = hashlib.sha256()
    h.update(repr(list(map(str, df.index))).encode())
    h.update(repr(list(map(str, df.columns))).encode())
    h.update(np.ascontiguousarray(vals).tobytes())
    columns = {
        str(col): _column_summary(vals[:, i]) for i, col in enumerate(num.columns)
    }
    return {
        "kind": "frame",
        "sha256": h.hexdigest(),
        "shape": [int(s) for s in df.shape],
        "columns": columns,
    }


def summarize_arrays(arrays: Dict[str, np.ndarray]) -> dict:
    """Summary of a named array bundle (e.g. the serving state's leaves);
    the content hash is ``registry.integrity.array_bundle_digest``, the digest the
    array-bundle files embed."""
    columns = {}
    for name in sorted(arrays):
        arr = np.ascontiguousarray(np.asarray(arrays[name]))
        if np.issubdtype(arr.dtype, np.number) or arr.dtype == np.bool_:
            columns[name] = _column_summary(arr.astype(np.float64))
            columns[name]["shape"] = [int(s) for s in arr.shape]
    return {
        "kind": "arrays",
        "sha256": array_bundle_digest(arrays),
        "columns": columns,
    }


def compare_summaries(
    name: str, prev: dict, cur: dict, band: Optional[DriftBand] = None
) -> List[Violation]:
    """Tolerance-banded comparison of two summaries of artifact ``name``:
    one fail-severity violation per drifted (column, moment), plus
    structural findings (shape/column-set changes)."""
    band = band or DriftBand()
    rule = f"drift.{name}"
    if prev.get("sha256") and prev.get("sha256") == cur.get("sha256"):
        return []  # bit-identical artifact
    out: List[Violation] = []
    if prev.get("shape") != cur.get("shape") and prev.get("shape") is not None:
        out.append(Violation(
            rule, "fail", f"shape moved {prev.get('shape')} -> {cur.get('shape')}",
        ))
    prev_cols = prev.get("columns", {})
    cur_cols = cur.get("columns", {})
    missing = sorted(set(prev_cols) - set(cur_cols))
    added = sorted(set(cur_cols) - set(prev_cols))
    if missing or added:
        out.append(Violation(
            rule, "fail", f"column set changed: missing {missing}, added {added}",
        ))
    for col in sorted(set(prev_cols) & set(cur_cols)):
        p, c = prev_cols[col], cur_cols[col]
        if p.get("finite") != c.get("finite"):
            out.append(Violation(
                rule, "fail",
                f"{col}: finite count moved {p.get('finite')} -> {c.get('finite')}",
            ))
            continue
        for moment in _MOMENTS:
            pv, cv = p.get(moment), c.get(moment)
            if not band.holds(pv, cv):
                delta = (cv - pv) if (pv is not None and cv is not None) else None
                out.append(Violation(
                    rule, "fail",
                    f"{col}.{moment} drifted {pv!r} -> {cv!r} "
                    f"(delta {delta!r}, band rtol={band.rtol:g} atol={band.atol:g})",
                ))
    return out


class DriftSentinel:
    """Compare this run's artifact summaries against the previous audit
    manifest, then atomically commit the new manifest::

        sentinel = DriftSentinel(audit_dir, fingerprint)
        sentinel.check("table_2", summarize_frame(table_2))
        sentinel.check("panel_stats", probe)     # contracts.panel_probe
        sentinel.raise_on_drift(audit)           # fail loudly, keep manifest
        sentinel.commit(audit)                   # clean: new trusted manifest
    """

    def __init__(self, audit_dir, fingerprint: str):
        self.dir = Path(audit_dir)
        self.fingerprint = str(fingerprint)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._prev_artifacts: Dict[str, dict] = {}
        self.rebaselined = False
        self._next: Dict[str, dict] = {}
        self._violations: List[Violation] = []
        path = self.dir / MANIFEST_NAME
        try:
            meta = json.loads(path.read_text())
            if meta.get("fingerprint") == self.fingerprint:
                self._prev_artifacts = dict(meta.get("artifacts", {}))
            else:
                # different data/dtype: re-baseline rather than report
                # phantom drift
                self.rebaselined = True
        except FileNotFoundError:
            pass
        except (OSError, ValueError):
            self.rebaselined = True  # torn manifest: start a fresh baseline

    def check(self, name: str, summary: dict,
              band: Optional[DriftBand] = None) -> List[Violation]:
        """Stage ``summary`` for the next manifest; compare against the
        previous run's summary of the same artifact when one exists."""
        self._next[name] = summary
        prev = self._prev_artifacts.get(name)
        if prev is None:
            return []
        found = compare_summaries(name, prev, summary, band=band)
        self._violations.extend(found)
        return found

    @property
    def violations(self) -> List[Violation]:
        return list(self._violations)

    def raise_on_drift(self, audit: Optional[AuditRecord] = None) -> None:
        """Fail loudly with the full per-column report. The previous
        (trusted) manifest is NOT overwritten on failure."""
        if not self._violations:
            return
        if audit is not None:
            audit.record(self._violations)
        report = "\n".join(str(v) for v in self._violations)
        raise DriftDetectedError(
            f"{len(self._violations)} drift violation(s) vs the audit "
            f"manifest at {self.dir / MANIFEST_NAME}:\n{report}"
        )

    def commit(self, audit: Optional[AuditRecord] = None) -> Path:
        """Atomically write the new manifest: this run's summaries merged
        over artifacts the run did not produce."""
        import datetime

        artifacts = {**self._prev_artifacts, **self._next}
        payload = {
            "fingerprint": self.fingerprint,
            "written_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "artifacts": artifacts,
            "audit": audit.as_dict() if audit is not None else None,
        }
        path = self.dir / MANIFEST_NAME
        tmp = self.dir / f".{MANIFEST_NAME}.tmp-{os.getpid()}"
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
        os.replace(tmp, path)
        return path
