"""The port's file cache: no-pickle npz array bundles and cached frames.

``save_array_bundle``/``load_array_bundle`` are the reference package's
array-bundle format (its serving state's): one ``np.savez_compressed`` file
holding the named arrays and a ``__meta__`` JSON scalar (fixed-width
unicode, so the file loads with ``allow_pickle`` off). The metadata records
``registry.integrity.array_bundle_digest`` over every array, so a bundle
written by either package loads, verified, in the other.

``write_cache_data``/``save_cache_data`` write a frame (parquet or csv) and
``load_cache_data`` reads one back by its file name, as the raw-data route
of the pipeline does. Every write is atomic (temporary file in the same
directory + ``os.replace``): a crash mid-write leaves the old file or
nothing, never a torn artifact. The writers carry the fault sites
``cache.write_cache_data`` and ``cache.save_array_bundle``
(``resilience.faults``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import pandas as pd

from fm_returnprediction_tpu_torch.registry.integrity import array_bundle_digest
from fm_returnprediction_tpu_torch.resilience.errors import CorruptArtifactError
from fm_returnprediction_tpu_torch.resilience.faults import fault_site

__all__ = ["CorruptArtifactError", "array_bundle_digest", "save_array_bundle",
           "load_array_bundle", "read_cached_data", "write_cache_data",
           "save_cache_data", "load_cache_data"]

_FRAME_EXTS = ("parquet", "csv")


@contextlib.contextmanager
def _atomic_replace(filepath: Path):
    """Yield a temporary path in the same directory, then ``os.replace`` it
    over ``filepath``: a crash mid-write leaves the old file or nothing.
    The temporary name keeps the real suffix (``np.savez`` appends
    ``.npz`` to anything else) and is salted with the process and thread,
    so concurrent writers never share one."""
    filepath = Path(filepath)
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


_BUNDLE_META_KEY = "__meta__"
_BUNDLE_HASH_KEY = "__sha256__"  # meta-dict slot for the content checksum


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
    fault_site("cache.save_array_bundle", path=path)
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


def read_cached_data(filepath: Union[Path, str], columns=None) -> pd.DataFrame:
    """Read a cached frame. ``columns`` prunes the read: parquet reads only
    the named column chunks, csv passes them as ``usecols``."""
    fmt = Path(filepath).suffix.lstrip(".")
    if fmt == "csv":
        return pd.read_csv(filepath, usecols=columns)
    if fmt == "parquet":
        return pd.read_parquet(filepath, columns=columns)
    raise ValueError(f"Unsupported file format: {fmt}")


def write_cache_data(df: pd.DataFrame, filepath: Union[Path, str]) -> None:
    """Write a frame by its file's extension (parquet or csv), atomically."""
    filepath = Path(filepath)
    fmt = filepath.suffix.lstrip(".")
    if fmt not in _FRAME_EXTS:
        raise ValueError(f"Unsupported file format: {fmt}")
    with _atomic_replace(filepath) as tmp:
        if fmt == "parquet":
            df.to_parquet(tmp, index=False)
        else:
            df.to_csv(tmp, index=False)
    fault_site("cache.write_cache_data", path=filepath)


def save_cache_data(df: pd.DataFrame, data_dir: Union[Path, str], file_name: str) -> Path:
    """Save ``df`` atomically as ``data_dir/file_name`` (the name carries its
    ``.parquet`` or ``.csv`` extension). Returns the path written."""
    cache_path = Path(data_dir, file_name)
    write_cache_data(df, cache_path)
    return cache_path


def load_cache_data(data_dir: Union[Path, str], file_name: str,
                    columns=None) -> pd.DataFrame:
    """Load a cached frame by exact name, raising ``FileNotFoundError`` if
    absent."""
    path = Path(data_dir, file_name)
    if not path.exists():
        raise FileNotFoundError(f"File {file_name} not found in {data_dir}.")
    return read_cached_data(path, columns=columns)
