"""No-pickle npz array bundles with a content checksum.

The port's own copy of the array-bundle format the reference package
writes for its serving state: one ``np.savez_compressed`` file holding the
named arrays and a ``__meta__`` JSON scalar (fixed-width unicode, so the
file loads with ``allow_pickle`` off). The metadata records a sha256 over
every array's (name, dtype, shape, bytes) — ``array_bundle_digest``, byte
for byte the reference's definition — so a bundle written by either
package loads, verified, in the other.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

__all__ = ["CorruptArtifactError", "array_bundle_digest", "save_array_bundle",
           "load_array_bundle"]

_BUNDLE_META_KEY = "__meta__"
_BUNDLE_HASH_KEY = "__sha256__"  # meta-dict slot for the content checksum


class CorruptArtifactError(RuntimeError):
    """A persisted artifact is structurally unreadable or failed its
    content checksum."""


def array_bundle_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Order-independent content hash over (name, dtype, shape, bytes) of
    every array."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        arr = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(f"{name}|{arr.dtype.str}|{arr.shape}|".encode())
        h.update(arr.data)
    return h.hexdigest()


@contextlib.contextmanager
def _atomic_replace(filepath: Path):
    """Yield a temp path in the same directory, then ``os.replace`` it over
    ``filepath``: a crash mid-write leaves the old file or nothing. The
    temp name keeps the ``.npz`` suffix (``np.savez`` appends one to
    anything else) and is pid+thread salted."""
    filepath.parent.mkdir(parents=True, exist_ok=True)
    tmp = filepath.parent / (
        f".{filepath.stem}.tmp-{os.getpid()}-{threading.get_ident()}"
        f"{filepath.suffix}"
    )
    try:
        yield tmp
        os.replace(tmp, filepath)
    finally:
        tmp.unlink(missing_ok=True)


def save_array_bundle(
    path: Union[Path, str],
    arrays: Dict[str, np.ndarray],
    meta: Optional[Dict[str, Any]] = None,
) -> Path:
    """Write a named set of arrays + a JSON metadata blob as one npz,
    atomically, with the content checksum in the metadata. Returns the
    path written (``.npz`` appended when missing)."""
    path = Path(path)
    if path.suffix != ".npz":
        path = Path(str(path) + ".npz")
    # names that collide with np.savez_compressed's own parameters would be
    # consumed as keyword arguments instead of saved
    reserved = {_BUNDLE_META_KEY, "file", "args", "kwds", "allow_pickle"}
    bad = reserved.intersection(arrays)
    if bad:
        raise ValueError(f"array names {sorted(bad)!r} are reserved")
    if meta and _BUNDLE_HASH_KEY in meta:
        raise ValueError(f"meta key {_BUNDLE_HASH_KEY!r} is reserved")
    meta_out = {**(meta or {}), _BUNDLE_HASH_KEY: array_bundle_digest(arrays)}
    with _atomic_replace(path) as tmp:
        np.savez_compressed(
            tmp, **{_BUNDLE_META_KEY: np.asarray(json.dumps(meta_out))}, **arrays)
    return path


def load_array_bundle(
    path: Union[Path, str],
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(arrays, meta)`` of a bundle written by :func:`save_array_bundle`.
    Raises ``FileNotFoundError`` when absent and :class:`CorruptArtifactError`
    when unreadable or when the stored content hash does not match."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Array bundle {path} not found.")
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = (json.loads(str(z[_BUNDLE_META_KEY][()]))
                    if _BUNDLE_META_KEY in z.files else {})
            arrays = {k: z[k] for k in z.files if k != _BUNDLE_META_KEY}
    except (zipfile.BadZipFile, OSError, ValueError, KeyError, EOFError) as exc:
        raise CorruptArtifactError(f"array bundle {path} is unreadable: {exc!r}") from exc
    stored = meta.pop(_BUNDLE_HASH_KEY, None)
    if stored is not None and stored != array_bundle_digest(arrays):
        raise CorruptArtifactError(f"array bundle {path} failed its content hash")
    return arrays, meta
