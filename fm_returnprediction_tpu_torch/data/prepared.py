"""The prepared-inputs slot: a warm run skips the host ingest.

The host ingest (reading the raw parquet, the universe filter, the
relational transforms, the daily compaction and the dense monthly scatter)
is a pure function of the five raw cache files, the compute dtype and the
``INCLUDE_TURNOVER`` column set, so the pipeline keeps its two products:

- the dense monthly BASE panel (``panel.dense.DensePanel`` over
  BASE_COLUMNS [+ vol]), the input of the characteristic engine;
- the per-firm compacted daily strips and calendar vectors
  (``panel.daily.CompactDaily``), the input of the daily kernels.

Layout v3, the reference package's byte for byte, so a slot written by
either package loads in the other: one raw ``.npy`` file per array under
``<raw_dir>/_prepared/`` (``base.<name>.npy``, ``daily.<field>.npy``) and a
``meta.json`` with the fingerprint, the datetime units, ``n_weeks``,
``n_months`` and a sha256 + byte-size manifest of every payload. Loads map
the payloads with ``np.load(mmap_mode="r")``: the load reads headers and
checks sizes, and the bytes page in where they are consumed (the copy to
the device, the daily strip assembly). The arrays come back READ-ONLY;
every consumer copies before writing.

Integrity: a load always checks structure and sizes; a mismatch, a missing
or unreadable payload degrades to a rebuild with a warning, never an
error. The full content re-hash costs the reads the mapping avoids, so it
is opt-in: ``FMRP_PREPARED_VERIFY=1``. Validity is a fingerprint over the
raw files' (name, size, mtime_ns), the dtype, a caller salt and the layout
version; ``meta.json`` is written last (temporary file + rename), so a
crashed writer leaves a stale slot, never a half-valid one.
``PREPARED_CACHE=0`` disables reading and writing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from fm_returnprediction_tpu_torch.data.synthetic import FILE_NAMES
from fm_returnprediction_tpu_torch.guard.contracts import numpy_dtype
from fm_returnprediction_tpu_torch.panel.daily import CompactDaily
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.registry import integrity as _integrity
from fm_returnprediction_tpu_torch.resilience.errors import CorruptArtifactError
from fm_returnprediction_tpu_torch.settings import config

__all__ = [
    "PREPARED_DIRNAME",
    "prepared_enabled",
    "prepared_candidates",
    "raw_fingerprint",
    "save_prepared",
    "load_prepared",
]

PREPARED_DIRNAME = "_prepared"
# The layout version, part of the fingerprint; the reference package's.
_VERSION = 3

_META_FILE = "meta.json"
# payloads of older layouts, removed by the next save
_STALE_FILES = ("dense_base.npz", "compact_daily.npz", "monthly_merged.parquet")

_BASE_ARRAYS = ("values", "mask", "months", "ids", "var_names")
_DAILY_ARRAYS = (
    "row_values", "row_pos", "offsets", "ids", "mkt", "mkt_present",
    "days", "day_month_id", "week_id", "week_month_id",
)


def prepared_enabled() -> bool:
    """The ``PREPARED_CACHE`` setting (default 1: on)."""
    return bool(config("PREPARED_CACHE"))


def raw_fingerprint(raw_dir, dtype, salt: str = "") -> str:
    """The staleness key of the slot under ``raw_dir``: each raw cache
    file's (name, size, mtime_ns), the compute dtype (a torch or numpy
    dtype, hashed as numpy's ``dtype.str``), ``salt`` (the caller's
    settings that change the payload, e.g. ``turnover=1``) and the layout
    version. A missing raw file raises here."""
    h = hashlib.sha256()
    h.update(f"v{_VERSION}|{numpy_dtype(dtype).str}|{salt}".encode())
    for name in sorted(FILE_NAMES.values()):
        st = (Path(raw_dir) / name).stat()
        h.update(f"|{name}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


def prepared_candidates(raw_dir) -> List[Path]:
    """The slots to try, in order; saves go to the first. With a registry
    armed (``FMRP_REGISTRY_DIR``) the slot lives under its root, keyed by
    the raw directory's absolute path (two raw caches do not share a
    slot), and ``<raw_dir>/_prepared`` stays as a read fallback; without
    one, only ``<raw_dir>/_prepared``."""
    from fm_returnprediction_tpu_torch.registry.store import active_registry

    legacy = Path(raw_dir) / PREPARED_DIRNAME
    reg = active_registry()
    if reg is None:
        return [legacy]
    slot = hashlib.sha256(str(Path(raw_dir).resolve()).encode()).hexdigest()[:16]
    return [reg.prepared_root(slot), legacy]


def _write_npy(prepared_dir: Path, name: str, arr: np.ndarray, manifest: dict) -> None:
    """One atomic ``.npy`` write (temporary file + rename) and its manifest
    entry."""
    path = prepared_dir / f"{name}.npy"
    tmp = prepared_dir / f".{name}.tmp{os.getpid()}.npy"
    try:
        with open(tmp, "wb") as f:
            np.lib.format.write_array(f, np.ascontiguousarray(arr), allow_pickle=False)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    manifest[f"{name}.npy"] = _integrity.manifest_entry(path)


def save_prepared(prepared_dir, fingerprint: str, base: DensePanel, cd: CompactDaily) -> None:
    """Write the v3 slot; ``meta.json`` goes last, so a partial write reads
    as a stale slot. A failure to write degrades to a warning."""
    prepared_dir = Path(prepared_dir)
    try:
        prepared_dir.mkdir(parents=True, exist_ok=True)
        meta_path = prepared_dir / _META_FILE
        meta_path.unlink(missing_ok=True)  # invalidate before the payloads
        for stale in _STALE_FILES:
            (prepared_dir / stale).unlink(missing_ok=True)

        manifest: dict = {}
        base_arrays = {
            "values": np.asarray(base.values),
            "mask": np.asarray(base.mask),
            "months": base.months.astype(np.int64),
            "ids": np.asarray(base.ids),
            # fixed-width unicode, not object dtype: loads with pickling off
            "var_names": np.asarray(base.var_names, dtype=np.str_),
        }
        for name, arr in base_arrays.items():
            _write_npy(prepared_dir, f"base.{name}", arr, manifest)
        for field in dataclasses.fields(cd):
            value = getattr(cd, field.name)
            if not isinstance(value, np.ndarray):
                continue
            if field.name == "days":
                value = value.astype(np.int64)  # the unit goes to meta.json
            _write_npy(prepared_dir, f"daily.{field.name}", value, manifest)

        tmp = meta_path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps({
            "fingerprint": fingerprint,
            "version": _VERSION,
            "months_unit": np.datetime_data(base.months.dtype)[0],
            "days_unit": np.datetime_data(cd.days.dtype)[0],
            "n_weeks": cd.n_weeks,
            "n_months": cd.n_months,
            "manifest": manifest,
        }))
        os.replace(tmp, meta_path)
    except OSError as exc:  # a read-only raw directory, a full disk
        warnings.warn(f"prepared-inputs checkpoint not written: {exc!r}", stacklevel=2)


def _verify_on_load() -> bool:
    return os.environ.get("FMRP_PREPARED_VERIFY", "0") == "1"


def _load_payload(prepared_dir: Path, name: str, meta: dict) -> np.ndarray:
    """One payload, memory-mapped read-only, checked against the manifest
    (its sha256 too with ``FMRP_PREPARED_VERIFY=1``)."""
    fname = f"{name}.npy"
    entry = meta.get("manifest", {}).get(fname)
    if entry is None:
        raise CorruptArtifactError(f"{fname} missing from manifest")
    path = prepared_dir / fname
    _integrity.verify_entry(path, entry, deep=_verify_on_load())
    try:
        return np.load(path, mmap_mode="r", allow_pickle=False)
    except (OSError, ValueError) as exc:
        raise CorruptArtifactError(f"{fname} unreadable: {exc!r}") from exc


def load_prepared(prepared_dir, fingerprint: str) -> Optional[Tuple[DensePanel, CompactDaily]]:
    """The slot's ``(base, compact_daily)`` when present and valid for
    ``fingerprint``, else None (with a warning when the slot is damaged).
    The arrays are read-only memory maps of the payload files."""
    prepared_dir = Path(prepared_dir)
    try:
        meta = json.loads((prepared_dir / _META_FILE).read_text())
    except (OSError, ValueError):
        return None
    if meta.get("version") != _VERSION or meta.get("fingerprint") != fingerprint:
        return None
    try:
        b = {n: _load_payload(prepared_dir, f"base.{n}", meta) for n in _BASE_ARRAYS}
        d = {n: _load_payload(prepared_dir, f"daily.{n}", meta) for n in _DAILY_ARRAYS}
        base = DensePanel(
            values=b["values"],
            mask=b["mask"],
            months=np.asarray(b["months"]).view(f"datetime64[{meta['months_unit']}]"),
            ids=b["ids"],
            var_names=[str(v) for v in b["var_names"]],
        )
        cd = CompactDaily(
            row_values=d["row_values"],
            row_pos=d["row_pos"],
            offsets=d["offsets"],
            ids=d["ids"],
            mkt=d["mkt"],
            mkt_present=d["mkt_present"],
            days=np.asarray(d["days"]).view(f"datetime64[{meta['days_unit']}]"),
            day_month_id=d["day_month_id"],
            week_id=d["week_id"],
            n_weeks=int(meta["n_weeks"]),
            week_month_id=d["week_month_id"],
            n_months=int(meta["n_months"]),
        )
    except (CorruptArtifactError, KeyError, ValueError, OSError) as exc:
        warnings.warn(f"prepared-inputs checkpoint unreadable, rebuilding: {exc!r}",
                      stacklevel=2)
        return None
    return base, cd
