"""Per-stage pipeline checkpoints: resume a crashed run, do not refit it.

The prepared-inputs slot (``data.prepared``) covers the host ingest; this
covers the reporting stages. ``run_pipeline(checkpoint_dir=...)`` records
each completed stage artifact here (Table 1, Table 2, the decile table, the
serving state), and a rerun after a crash loads the completed stages and
recomputes only from the failure point on.

Contract (the reference package's):

- one directory per run family, keyed by a FINGERPRINT (panel identity +
  data provenance + dtype); a different fingerprint invalidates every
  recorded stage, so a checkpoint never leaks across datasets;
- every artifact is written atomically (temporary file + ``os.replace``)
  and recorded in the manifest with its file sha256; a load verifies the
  hash, and a mismatch or an unreadable artifact degrades to recomputing
  that stage, with a warning;
- the manifest is written last and atomically, so a crash mid-save leaves
  the previous consistent manifest.

``OUTCOMES`` counts each load or save by outcome (``hit``, ``miss``,
``corrupt``, ``save``) for the whole process; each outcome also counts
into the metrics family ``fmrp_checkpoint_total{outcome=...}`` and, with
tracing on, is a ``checkpoint.<outcome>`` event.
"""

from __future__ import annotations

import json
import os
import warnings
from collections import Counter
from pathlib import Path
from typing import Callable

import pandas as pd

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.resilience.errors import CorruptArtifactError

__all__ = ["OUTCOMES", "StageCheckpointer"]

_MANIFEST = "manifest.json"


def _file_sha256(path: Path) -> str:
    # imported at the call: ``registry.integrity`` imports this package's
    # errors, so a module-level import would be a cycle through
    # ``resilience/__init__``
    from fm_returnprediction_tpu_torch.registry.integrity import file_sha256

    return file_sha256(path)

OUTCOMES: Counter = Counter()


def _outcome(outcome: str, name: str, **attrs) -> None:
    OUTCOMES[outcome] += 1
    telemetry.registry().counter(
        "fmrp_checkpoint_total",
        help="stage checkpoint-resume outcomes by kind",
        outcome=outcome,
    ).inc()
    telemetry.event(f"checkpoint.{outcome}", cat="resilience", stage=name, **attrs)


class StageCheckpointer:
    """Fingerprint-keyed, checksum-verified stage artifact store."""

    def __init__(self, checkpoint_dir, fingerprint: str):
        self.dir = Path(checkpoint_dir)
        self.fingerprint = str(fingerprint)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._stages = {}
        try:
            meta = json.loads((self.dir / _MANIFEST).read_text())
            if meta.get("fingerprint") == self.fingerprint:
                self._stages = dict(meta.get("stages", {}))
        except (OSError, ValueError):
            pass  # an absent or torn manifest starts empty

    def _write_manifest(self) -> None:
        tmp = self.dir / f".{_MANIFEST}.tmp-{os.getpid()}"
        tmp.write_text(json.dumps({"fingerprint": self.fingerprint, "stages": self._stages},
                                  indent=2, sort_keys=True))
        os.replace(tmp, self.dir / _MANIFEST)

    def completed(self, name: str) -> bool:
        """Whether stage ``name`` is recorded and its file present (its
        content is verified when it loads)."""
        rec = self._stages.get(name)
        return rec is not None and (self.dir / rec["file"]).exists()

    def stages(self) -> tuple:
        return tuple(sorted(self._stages))

    def stage(self, name: str, compute: Callable[[], object], *,
              saver: Callable[[object, Path], None], loader: Callable[[Path], object],
              suffix: str):
        """Load stage ``name`` when recorded and intact, else compute it,
        persist it atomically, record it and return it. A crash inside
        ``compute`` leaves the earlier stages recorded and this one absent:
        a rerun resumes at the last completed stage."""
        got = self._load(name, loader)
        if got is not None:
            return got
        obj = compute()
        self._store(name, obj, saver, suffix)
        return obj

    def _store(self, name, obj, saver, suffix) -> None:
        try:
            self._save(name, obj, saver, suffix)
        except OSError as exc:  # read-only directory, disk full: keep the result
            warnings.warn(f"stage checkpoint {name!r} not written: {exc!r}", stacklevel=3)

    def _load(self, name: str, loader: Callable[[Path], object]):
        rec = self._stages.get(name)
        if rec is None:
            _outcome("miss", name)
            return None
        path = self.dir / rec["file"]
        try:
            if not path.exists():
                raise CorruptArtifactError(f"checkpoint file {path} missing")
            if _file_sha256(path) != rec["sha256"]:
                raise CorruptArtifactError(f"checkpoint {name!r} failed its content hash")
            got = loader(path)
        except Exception as exc:  # noqa: BLE001 — any unreadable artifact is rebuilt
            _outcome("corrupt", name, error=repr(exc)[:200])
            warnings.warn(f"stage checkpoint {name!r} unreadable, recomputing: {exc!r}",
                          stacklevel=3)
            # drop the record so completed() stops advertising it
            self._stages.pop(name, None)
            try:
                self._write_manifest()
            except OSError:
                pass
            return None
        _outcome("hit", name)
        return got

    def _save(self, name, obj, saver, suffix) -> None:
        final = self.dir / f"{name}{suffix}"
        tmp = self.dir / f".{name}.tmp-{os.getpid()}{suffix}"
        try:
            saver(obj, tmp)
            os.replace(tmp, final)
        finally:
            tmp.unlink(missing_ok=True)
        self._stages[name] = {"file": final.name, "sha256": _file_sha256(final)}
        self._write_manifest()
        _outcome("save", name)

    def frame(self, name: str, compute: Callable[[], object]):
        """A pickled stage (a DataFrame, or a dict of numpy arrays): pickle
        keeps the tables' MultiIndex shapes, and the manifest's sha256
        guards the file."""
        return self.stage(name, compute, saver=_pickle, loader=pd.read_pickle, suffix=".pkl")

    def load_frame(self, name: str):
        """The verified pickled stage ``name``, or None when it is absent or
        fails its hash (then counted ``corrupt`` and dropped, as in
        :meth:`frame`). For a caller whose work before the stage depends on
        whether the stage will load."""
        return self._load(name, pd.read_pickle)

    def save_frame(self, name: str, obj) -> None:
        """Record the pickled stage ``name`` computed after :meth:`load_frame`
        returned None."""
        self._store(name, obj, _pickle, ".pkl")


def _pickle(obj, path) -> None:
    pd.to_pickle(obj, path)
