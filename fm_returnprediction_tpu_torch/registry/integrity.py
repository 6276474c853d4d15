"""The one integrity layer for persisted artifacts.

Every persisted thing of the port answers the same question — are these
bytes the bytes that were written — with a sha256, and fails the same way,
with the typed :class:`CorruptArtifactError` the caller degrades on: the
prepared-inputs slot's ``meta.json`` manifest (``data.prepared``), the
array-bundle digest ``utils.cache.save_array_bundle`` embeds, the drift
sentinel's array-artifact hash (``guard.drift``) and the stage
checkpoints' manifest (``resilience.checkpoint``) and the registry's
entries (``registry.store``).

The digests are the reference package's byte for byte: ``file_sha256``
hashes the raw file bytes and ``array_bundle_digest`` frames
``name|dtype|shape|`` over the sorted names, so a manifest, bundle or
audit baseline written by either package verifies in the other.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Iterable, Union

import numpy as np

from fm_returnprediction_tpu_torch.resilience.errors import CorruptArtifactError

__all__ = [
    "CorruptArtifactError",
    "file_sha256",
    "array_bundle_digest",
    "manifest_entry",
    "build_manifest",
    "verify_entry",
    "verify_manifest",
    "hash_files",
]

_CHUNK = 1 << 22


def file_sha256(path: Union[Path, str]) -> str:
    """Streaming sha256 over a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_CHUNK), b""):
            h.update(block)
    return h.hexdigest()


def array_bundle_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Order-independent content hash over (name, dtype, shape, bytes) of
    every array."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        arr = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(f"{name}|{arr.dtype.str}|{arr.shape}|".encode())
        h.update(arr.data)
    return h.hexdigest()


def manifest_entry(path: Union[Path, str]) -> dict:
    """One file's manifest record: ``{"sha256": ..., "size": ...}``."""
    path = Path(path)
    return {"sha256": file_sha256(path), "size": path.stat().st_size}


def build_manifest(paths: Iterable[Union[Path, str]]) -> Dict[str, dict]:
    """Manifest over several files, keyed by file name (a registry entry
    and a prepared slot keep their payloads flat in one directory)."""
    return {Path(p).name: manifest_entry(p) for p in paths}


def verify_entry(path: Union[Path, str], entry: dict, deep: bool = False) -> None:
    """Check one payload file against its manifest record.

    The size always verifies (one ``stat``); the full content re-hash is
    ``deep`` opt-in, because it costs the reads that memory-mapped loads
    exist to avoid. A mismatch or an unreadable file raises
    :class:`CorruptArtifactError`."""
    path = Path(path)
    name = path.name
    if not isinstance(entry, dict):
        raise CorruptArtifactError(f"{name} has no manifest entry")
    try:
        size = path.stat().st_size
    except OSError as exc:
        raise CorruptArtifactError(f"{name} unreadable: {exc!r}") from exc
    if size != entry.get("size"):
        raise CorruptArtifactError(
            f"{name} is {size} bytes, manifest says {entry.get('size')}")
    if deep:
        try:
            digest = file_sha256(path)
        except OSError as exc:
            raise CorruptArtifactError(f"{name} unreadable during verify: {exc!r}") from exc
        if digest != entry.get("sha256"):
            raise CorruptArtifactError(f"{name} failed its content sha256")


def verify_manifest(directory: Union[Path, str], manifest: Dict[str, dict],
                    deep: bool = False) -> None:
    """Verify every manifest record against the files in ``directory``."""
    directory = Path(directory)
    for name, entry in manifest.items():
        verify_entry(directory / name, entry, deep=deep)


def hash_files(paths: Iterable[Union[Path, str]]) -> str:
    """One digest over several files' (name, bytes), in name order."""
    h = hashlib.sha256()
    for p in sorted(Path(p) for p in paths):
        h.update(p.name.encode())
        h.update(b"|")
        h.update(p.read_bytes())
    return h.hexdigest()
