"""Artifact plane: one schema-versioned store for fitted artifacts.

The pipeline's array/frame products historically flowed through ad-hoc
paths — ``serving_state.npz`` wherever the caller pointed, specgrid
frames as loose CSV/parquet, audit manifests under ``--audit-dir`` — each
with its own (or no) integrity story. The artifact plane gives them one
address (``<registry>/artifacts/<name>/<fingerprint>/``) and ONE
integrity layer: every entry's ``meta.json`` carries the
:mod:`.integrity` sha256+size manifest over its payload files, the same
manifest shape the guard audit and prepared checkpoint already use.

``fingerprint`` is the caller's data-provenance key (the pipeline passes
its ``_pipeline_fingerprint``), so an entry answers "the serving state
FOR this panel+dtype+raw-data", not just "a serving state". ``latest``
resolution (newest entry by write time) serves the warm-pool path, where
a fresh replica wants "whatever the last publish was".

The entries are the reference package's, key for key: a serving state
either package publishes loads in the other.
"""

from __future__ import annotations

import time
import warnings
from pathlib import Path
from typing import List, Optional, Union

from fm_returnprediction_tpu_torch.registry import integrity
from fm_returnprediction_tpu_torch.registry.store import Registry, active_registry

__all__ = [
    "put_files",
    "put_serving_state",
    "get_entry_dir",
    "get_file",
    "load_serving_state",
    "list_entries",
]

SERVING_STATE_NAME = "serving_state"
SERVING_STATE_FILE = "serving_state.npz"


def put_files(
    name: str,
    fingerprint: str,
    paths: List[Union[Path, str]],
    registry: Optional[Registry] = None,
    meta: Optional[dict] = None,
) -> Optional[Path]:
    """Register existing payload files as one artifact entry (copied in,
    manifest built, meta published last). Returns the entry dir, or None
    when the registry is off or the write failed (warned — artifact
    registration is an accelerant, never a correctness gate)."""
    registry = registry or active_registry()
    if registry is None:
        return None
    # the reference returns here on every process but the first of a
    # pod; the port runs in one process, so it always writes
    try:
        return registry.write_entry_from_paths(
            registry.artifact_dir(name, fingerprint),
            [Path(p) for p in paths],
            {
                "kind": "artifact",
                "name": name,
                "fingerprint": str(fingerprint),
                "files": [Path(p).name for p in paths],
                "created_at": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                ),
                **(meta or {}),
            },
        )
    except Exception as exc:  # noqa: BLE001 — see docstring
        warnings.warn(
            f"artifact registration failed for {name!r} ({exc!r})",
            stacklevel=2,
        )
        return None


def put_serving_state(
    state,
    fingerprint: str,
    registry: Optional[Registry] = None,
) -> Optional[Path]:
    """Publish a fitted ``ServingState`` into the artifact plane (saved
    via its own no-pickle npz contract, then registered)."""
    registry = registry or active_registry()
    if registry is None:
        return None
    import tempfile

    try:
        with tempfile.TemporaryDirectory() as td:
            path = state.save(Path(td) / SERVING_STATE_FILE)
            return put_files(
                SERVING_STATE_NAME, fingerprint, [path], registry=registry,
                meta={"n_months": int(state.n_months),
                      "n_predictors": int(state.n_predictors)},
            )
    except Exception as exc:  # noqa: BLE001 — accelerant, never a gate
        warnings.warn(
            f"serving-state registration failed ({exc!r})", stacklevel=2
        )
        return None


def list_entries(
    name: str, registry: Optional[Registry] = None
) -> List[Path]:
    """Readable entries for one artifact name, oldest → newest by
    recorded write time (torn/schema-skewed entries excluded)."""
    registry = registry or active_registry()
    if registry is None:
        return []
    root = registry.artifacts_root / name
    if not root.is_dir():
        return []
    stamped = []
    for entry in root.iterdir():
        meta = registry.read_meta(entry)
        if meta is not None:
            stamped.append((meta.get("created_at") or "", entry))
    return [e for _, e in sorted(stamped)]


def get_entry_dir(
    name: str,
    fingerprint: Optional[str] = None,
    registry: Optional[Registry] = None,
) -> Optional[Path]:
    """One artifact entry: by exact fingerprint, else the newest readable
    entry. None when absent (callers rebuild)."""
    registry = registry or active_registry()
    if registry is None:
        return None
    if fingerprint is not None:
        entry = registry.artifact_dir(name, str(fingerprint))
        return entry if registry.read_meta(entry) is not None else None
    entries = list_entries(name, registry=registry)
    return entries[-1] if entries else None


def get_file(
    name: str,
    filename: str,
    fingerprint: Optional[str] = None,
    registry: Optional[Registry] = None,
    deep: bool = False,
) -> Optional[Path]:
    """Resolve one payload file inside an artifact entry, verified
    against the entry manifest (size always; content hash when ``deep``).
    Corruption surfaces as the typed ``CorruptArtifactError`` — the
    caller's rebuild contract, same as every checkpoint path."""
    registry = registry or active_registry()
    if registry is None:
        return None
    entry = get_entry_dir(name, fingerprint, registry=registry)
    if entry is None:
        return None
    meta = registry.read_meta(entry) or {}
    path = entry / filename
    manifest_rec = meta.get("manifest", {}).get(filename)
    if manifest_rec is None:
        raise integrity.CorruptArtifactError(
            f"artifact {name}/{entry.name} has no manifest entry for "
            f"{filename}"
        )
    integrity.verify_entry(path, manifest_rec, deep=deep)
    return path


def load_serving_state(
    fingerprint: Optional[str] = None,
    registry: Optional[Registry] = None,
):
    """The registered ``ServingState`` (by fingerprint, else newest), or
    None when the plane holds none. Bundle-level corruption raises the
    bundle's own typed error (``utils.cache.load_array_bundle``)."""
    path = get_file(
        SERVING_STATE_NAME, SERVING_STATE_FILE, fingerprint,
        registry=registry,
    )
    if path is None:
        return None
    from fm_returnprediction_tpu_torch.serving.state import ServingState

    return ServingState.load(path)
