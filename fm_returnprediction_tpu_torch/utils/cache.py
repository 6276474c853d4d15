"""The port's file cache: no-pickle npz array bundles and cached frames.

``save_array_bundle``/``load_array_bundle`` are the reference package's
array-bundle format (its serving state's): one ``np.savez_compressed`` file
holding the named arrays and a ``__meta__`` JSON scalar (fixed-width
unicode, so the file loads with ``allow_pickle`` off). The metadata records
``registry.integrity.array_bundle_digest`` over every array, so a bundle
written by either package loads, verified, in the other.

``write_cache_data``/``save_cache_data`` write a frame (parquet, csv or a
zip holding one csv) and ``load_cache_data`` reads one back by its file
name, as the raw-data route of the pipeline does. The WRDS pullers
(``data.wrds_pull``) name their caches by the reference package's scheme:
``<code>__<safe-filters>.<ext>`` (``cache_filename``), or the dataset code,
the date filters and a 9-hex sha256 of the others (``hash_cache_filename``),
the first existing of ``.parquet``/``.csv``/``.zip`` winning
(``file_cached``). Every write is atomic (temporary file in the same
directory + ``os.replace``): a crash mid-write leaves the old file or
nothing, never a torn artifact. The writers carry the fault sites
``cache.write_cache_data`` and ``cache.save_array_bundle``
(``resilience.faults``).
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import json
import os
import re
import threading
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from fm_returnprediction_tpu_torch.registry.integrity import array_bundle_digest
from fm_returnprediction_tpu_torch.resilience.errors import CorruptArtifactError
from fm_returnprediction_tpu_torch.resilience.faults import fault_site

__all__ = ["CorruptArtifactError", "array_bundle_digest", "cache_filename", "file_cached",
           "flatten_dict_to_str", "hash_cache_filename", "save_array_bundle",
           "load_array_bundle", "read_cached_data", "write_cache_data",
           "save_cache_data", "load_cache_data"]

_FRAME_EXTS = ("parquet", "csv", "zip")


def flatten_dict_to_str(filters: Dict[str, Any]) -> str:
    """Flatten a (possibly nested) filter dict into a stable string key:
    ``{'ticker': ['AAPL'], 'date': {'gte': '2020-01-01'}}`` →
    ``"ticker=['AAPL'],date.gte=2020-01-01"``."""
    items: List[str] = []
    for key, value in filters.items():
        if isinstance(value, dict):
            items.extend(f"{key}.{sub}={subval}" for sub, subval in value.items())
        else:
            items.append(f"{key}={value}")
    return ",".join(items)


def _strip_keys(text: str) -> str:
    return re.sub(r"export=[a-zA-Z]*|[^,]*=", "", text)


def _char_clean(text: str) -> str:
    for old, new in (("/", "_"), ("=", "_"), (",", "_"), ("-", ""), (" ", ""), ("'", "")):
        text = text.replace(old, new)
    return text


def _sanitize(text: str) -> str:
    return _char_clean(_strip_keys(text))


def _split_filters(filters_str: str) -> List[str]:
    """Split a flattened filter string on top-level commas only, keeping
    bracketed list values (``date=['a', 'b']``) whole."""
    parts, cur, depth = [], [], 0
    for ch in filters_str:
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(depth - 1, 0)
        cur.append(ch)
    parts.append("".join(cur))
    return [p for p in parts if p]


def _cleanup(name: str) -> str:
    return name.replace("__.", ".").replace("_.", ".")


def cache_filename(code: str, filters_str: str, data_dir: Union[Path, str],
                   file_ext_list: tuple = _FRAME_EXTS) -> List[Path]:
    """Verbose cache paths ``<code>__<safe-filters>.<ext>`` for each
    extension. A filter string without a date component gets today's date
    appended, so undated pulls age out daily."""
    if "date" not in filters_str:
        filters_str += f"_{datetime.date.today().strftime('%Y%m%d')}"
    safe = _sanitize(filters_str)
    data_dir = Path(data_dir)
    return [data_dir / _cleanup(f"{code.replace('/', '_')}__{safe}.{ext}")
            for ext in file_ext_list]


def hash_cache_filename(code: str, filters_str: str, data_dir: Union[Path, str],
                        file_ext_list: tuple = _FRAME_EXTS) -> List[Path]:
    """Hashed cache paths ``<code>_<date-parts>_<9-hex sha256 of the rest>``:
    the filters whose key names a date stay readable in the name, the
    others fold into the hash, and the dataset code always leads, so two
    datasets with the same filters never collide."""
    if "date" not in filters_str and "end_date" not in filters_str:
        filters_str += f"_{datetime.date.today().strftime('%Y%m%d')}"
    parts = _split_filters(filters_str)
    keep_parts = [p for p in parts if "date" in p.partition("=")[0]]
    hash_parts = [p for p in parts if "date" not in p.partition("=")[0]]
    safe_keep = _char_clean(code) + "_" + _sanitize(",".join(keep_parts))
    digest = hashlib.sha256(_sanitize(",".join(hash_parts)).encode()).hexdigest()[:9]
    data_dir = Path(data_dir)
    return [data_dir / _cleanup(f"{safe_keep}_{digest}.{ext}") for ext in file_ext_list]


def file_cached(filepaths: List[Path]) -> Optional[Path]:
    """The first existing path among the candidates, else None."""
    for filepath in filepaths:
        if Path(filepath).exists():
            return Path(filepath)
    return None


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
    """Read a cached frame; a zip archive holds one member (parquet or
    csv). ``columns`` prunes the read: parquet reads only the named column
    chunks, csv passes them as ``usecols``."""
    fmt = Path(filepath).suffix.lstrip(".")
    if fmt == "csv":
        return pd.read_csv(filepath, usecols=columns)
    if fmt == "parquet":
        return pd.read_parquet(filepath, columns=columns)
    if fmt == "zip":
        with zipfile.ZipFile(filepath, "r") as archive:
            member = archive.namelist()[0]
            with archive.open(member) as handle:
                if member.endswith(".parquet"):
                    return pd.read_parquet(handle, columns=columns)
                return pd.read_csv(handle, usecols=columns)
    raise ValueError(f"Unsupported file format: {fmt}")


def write_cache_data(df: pd.DataFrame, filepath: Union[Path, str]) -> None:
    """Write a frame by its file's extension (parquet, csv, or a zip
    holding one csv named after the archive), atomically."""
    filepath = Path(filepath)
    fmt = filepath.suffix.lstrip(".")
    if fmt not in _FRAME_EXTS:
        raise ValueError(f"Unsupported file format: {fmt}")
    with _atomic_replace(filepath) as tmp:
        if fmt == "parquet":
            df.to_parquet(tmp, index=False)
        elif fmt == "csv":
            df.to_csv(tmp, index=False)
        else:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as archive:
                archive.writestr(filepath.stem + ".csv", df.to_csv(index=False))
    fault_site("cache.write_cache_data", path=filepath)


def save_cache_data(df: pd.DataFrame, data_dir: Union[Path, str],
                    cache_paths: Optional[List[Path]] = None,
                    file_name: Optional[str] = None,
                    file_type: Optional[str] = None) -> Path:
    """Save ``df`` atomically under ``file_name`` in ``data_dir`` (a name
    without a known extension gets ``file_type``, default parquet), or
    without a name at the first of ``cache_paths`` whose suffix is
    ``file_type``. Returns the path written."""
    if file_name is None:
        file_type = file_type or "parquet"
        cache_path = next((p for p in (cache_paths or []) if p.suffix == f".{file_type}"),
                          None)
        if cache_path is None:
            raise ValueError("No cache path matches the requested file type.")
    elif not any(file_name.endswith(f".{ext}") for ext in _FRAME_EXTS):
        cache_path = Path(data_dir, f"{file_name}.{file_type or 'parquet'}")
    else:
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
