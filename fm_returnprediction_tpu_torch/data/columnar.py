"""Chunked Arrow reads: raw parquet → numpy columns, without pandas frames.

The legacy ingest materializes every raw cache as a pandas DataFrame and
then row-filters it. This module reads the same parquet files as columnar
batches straight into numpy arrays:

- value columns decode once per batch (zero-copy where arrow allows);
- the share-class universe filter evaluates on the batches' DICTIONARY
  CODES (integer compares against the few admitted categories, as the
  legacy filter does on pandas categoricals; a cache that stores the flags
  as plain strings is read dictionary-encoded), and only the surviving rows
  are ever materialized;
- batches stream: peak memory is one batch of flag codes plus the filtered
  value columns, never the whole daily frame.

Semantics match ``data.wrds_pull.subset_to_common_stock_and_exchanges``
exactly: a row survives iff every flag column's value is in the admitted
set (nulls never match, as with ``Series.isin``). Anything the reader
cannot service (pyarrow missing, a non-parquet cache, absent columns)
raises the typed :class:`ColumnarIngestError`, and the pipeline falls back
to the legacy pandas route.

Read-ahead: ``ParquetFile.iter_batches`` decodes in arrow's C++ threads
(the GIL released) while the filter and gather run in Python.
``_prefetched`` overlaps the two: a reader thread pulls batches ahead into
a BOUNDED queue (depth ``FMRP_INGEST_PREFETCH``, default 2; 0 restores the
serial loop) while the consumer drains it. Batch order is preserved, a
reader-side exception re-raises at the consumer's next pull, and a consumer
that leaves early stops the reader.
"""

from __future__ import annotations

import os
import queue
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "ColumnarIngestError",
    "read_filtered_columns",
    "read_table_columns",
    "resolve_prefetch_depth",
]

# Streaming batch size (rows) for the chunked reader: ~4M rows keeps a
# batch's flag codes + values in tens of MB while amortizing per-batch
# decode overhead over the 77M-row daily file.
_BATCH_ROWS = 1 << 22

#: default read-ahead depth of the cold-ingest overlap queue
_PREFETCH_DEPTH = 2


def resolve_prefetch_depth(prefetch: Optional[int] = None) -> int:
    """Read-ahead depth for the chunked reader: explicit argument >
    ``FMRP_INGEST_PREFETCH`` env > 2. ``0`` (or anything unparseable,
    conservatively) disables the reader thread entirely — the serial loop
    is the differential oracle for the overlap."""
    if prefetch is not None:
        return max(int(prefetch), 0)
    raw = os.environ.get("FMRP_INGEST_PREFETCH", "").strip()
    if not raw:
        return _PREFETCH_DEPTH
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def _prefetched(batches: Iterable, depth: int) -> Iterator:
    """Yield from ``batches`` through a bounded read-ahead queue.

    A daemon reader thread advances the source iterator up to ``depth``
    items ahead; items come out in source order. If the reader raises, the
    exception surfaces at the consumer's next pull. If the CONSUMER stops
    early (exception upstream, generator close), the reader is told to
    stop and gives up its pending ``put``, so the thread never blocks on a
    full queue."""
    if depth <= 0:
        yield from batches
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        """Queue ``item`` unless the consumer has left; every put, the end
        marker and an exception too, gives up once ``stop`` is set, so the
        reader never blocks on a full queue nobody drains."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _reader():
        try:
            for item in batches:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as exc:  # noqa: BLE001 - re-raised consumer-side
            _put(exc)

    t = threading.Thread(target=_reader, name="fmrp-ingest-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


class ColumnarIngestError(RuntimeError):
    """The columnar reader cannot service this request (missing pyarrow,
    non-parquet cache, absent columns). The pipeline catches this and
    falls back to the legacy pandas ingest route."""


def _pyarrow():
    try:
        import pyarrow
        import pyarrow.parquet
    except ImportError as exc:  # pragma: no cover - pyarrow is baked in
        raise ColumnarIngestError(
            "pyarrow is unavailable; use FMRP_PANEL_ROUTE=legacy"
        ) from exc
    return pyarrow, pyarrow.parquet


def _to_numpy(arr) -> np.ndarray:
    """One arrow array/chunked-array → numpy, decoding dictionaries.

    Numeric/temporal columns convert zero-copy when null-free; dictionary
    (categorical) columns decode to their value type first — only the few
    SMALL columns that need values (e.g. ``gvkey``) should take this path,
    the flag filter never does.
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = pc.cast(arr, arr.type.value_type)
    return arr.to_numpy(zero_copy_only=False)


def _flag_keep_mask(columns: Mapping[str, object], spec) -> np.ndarray:
    """Row-keep mask for one batch: AND over every flag column's membership
    in its admitted set. Dictionary columns compare CODES (nulls are code
    -1 after ``fill_null``, matching nothing); other columns take Arrow's
    ``is_in`` (nulls match nothing) — both reproduce ``Series.isin``
    semantics. A column whose type cannot hold the admitted values raises
    :class:`ColumnarIngestError`."""
    import pyarrow as pa
    import pyarrow.compute as pc

    keep: Optional[np.ndarray] = None
    for name, wanted in spec.items():
        col = columns[name]
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if pa.types.is_dictionary(col.type):
            cats = col.dictionary.to_pylist()
            codes = col.indices.fill_null(-1).to_numpy(zero_copy_only=False)
            admitted = [i for i, c in enumerate(cats) if c in wanted]
            m = np.zeros(len(codes), dtype=bool)
            for code in admitted:
                m |= codes == code
        else:
            try:
                value_set = pa.array(list(wanted), type=col.type)
            except (pa.ArrowInvalid, pa.ArrowTypeError) as exc:
                raise ColumnarIngestError(
                    f"flag column {name!r} of type {col.type} cannot hold {list(wanted)}; "
                    "use FMRP_PANEL_ROUTE=legacy") from exc
            m = (pc.is_in(col, value_set=value_set).fill_null(False)
                 .to_numpy(zero_copy_only=False))
        keep = m if keep is None else keep & m
    if keep is None:
        raise ValueError("empty filter spec")
    return keep


def _require_columns(schema_names: Sequence[str], needed, path) -> None:
    missing = [c for c in needed if c not in schema_names]
    if missing:
        raise ColumnarIngestError(
            f"{Path(path).name} lacks columns {missing} needed by the "
            "columnar ingest route; use FMRP_PANEL_ROUTE=legacy"
        )


def read_filtered_columns(
    path,
    value_columns: Sequence[str],
    flag_spec: Mapping[str, Sequence[str]],
    bool_columns: Optional[Mapping[str, Sequence[str]]] = None,
    batch_rows: int = _BATCH_ROWS,
    prefetch: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Stream a parquet file and return the ``value_columns`` (plus derived
    ``bool_columns``) of the rows passing the flag filter, as numpy arrays.

    ``flag_spec``: column → admitted values (ANDed). ``bool_columns``:
    column → values, yielding a derived boolean output named after the
    column (evaluated on dictionary codes like the filter — used for
    ``is_nyse`` without materializing 13M exchange strings).
    ``prefetch``: read-ahead depth of the overlap queue (None resolves
    ``FMRP_INGEST_PREFETCH``; 0 = the serial oracle loop) — batch k+1
    decodes in arrow's C++ thread while batch k filters/gathers here.
    """
    pa_, pq_ = _pyarrow()
    path = Path(path)
    if path.suffix != ".parquet":
        raise ColumnarIngestError(
            f"columnar ingest reads parquet only, got {path.name}"
        )
    if not path.exists():
        raise FileNotFoundError(f"File {path.name} not found in {path.parent}.")
    bool_columns = dict(bool_columns or {})
    schema = pq_.ParquetFile(path).schema_arrow
    read_cols = list(dict.fromkeys(
        [*value_columns, *flag_spec, *bool_columns]
    ))
    _require_columns(schema.names, read_cols, path)
    # string flag columns are read dictionary-encoded, so the filter
    # compares codes whatever encoding the cache was written with
    as_dictionary = [
        c for c in dict.fromkeys([*flag_spec, *bool_columns])
        if pa_.types.is_string(schema.field(c).type)
        or pa_.types.is_large_string(schema.field(c).type)
    ]
    pf = pq_.ParquetFile(path, read_dictionary=as_dictionary)

    parts: Dict[str, List[np.ndarray]] = {
        c: [] for c in [*value_columns, *bool_columns]
    }
    import pyarrow as pa

    batches = _prefetched(
        pf.iter_batches(batch_size=batch_rows, columns=read_cols),
        resolve_prefetch_depth(prefetch),
    )
    for batch in batches:
        cols = {n: batch.column(i) for i, n in enumerate(batch.schema.names)}
        keep = _flag_keep_mask(cols, flag_spec)
        idx = np.flatnonzero(keep)
        take = pa.array(idx, type=pa.int64())
        for c in value_columns:
            # take-then-decode: only surviving rows ever materialize to
            # numpy (decode-then-mask would copy the full batch first)
            parts[c].append(_to_numpy(cols[c].take(take)))
        for c, wanted in bool_columns.items():
            m = _flag_keep_mask({c: cols[c]}, {c: wanted})
            parts[c].append(m[idx])
    out: Dict[str, np.ndarray] = {}
    for c, chunks in parts.items():
        out[c] = np.concatenate(chunks) if chunks else np.empty(0)
    return out


def read_table_columns(path, columns: Sequence[str]) -> Dict[str, np.ndarray]:
    """Read the named columns of a (small) parquet table as numpy arrays —
    the non-streaming sibling for Compustat / CCM / the daily index."""
    pa_, pq_ = _pyarrow()
    path = Path(path)
    if path.suffix != ".parquet":
        raise ColumnarIngestError(
            f"columnar ingest reads parquet only, got {path.name}"
        )
    if not path.exists():
        raise FileNotFoundError(f"File {path.name} not found in {path.parent}.")
    pf = pq_.ParquetFile(path)
    _require_columns(pf.schema_arrow.names, columns, path)
    table = pq_.read_table(path, columns=list(columns))
    return {c: _to_numpy(table.column(c)) for c in columns}
