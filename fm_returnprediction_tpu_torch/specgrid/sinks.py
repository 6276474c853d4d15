"""Streaming aggregation sinks — what a scenario sweep keeps per tile.

The engine (``specgrid.engine``) hands each completed tile to a sink as a
tidy ``pandas.DataFrame`` (one row per cell × predictor, global ``cell``
index included) and the sink decides what survives. Sinks are the reason a
10⁵-cell sweep's peak incremental memory is one tile, not one frame:

- ``FrameSink``   — keeps every tile and concatenates at the end. The
  small-grid default; bit-identical to the materialized route by
  construction (same per-tile frames, same order).
- ``TopKSink``    — a bounded leaderboard of the k most extreme rows by
  ``|t-stat|`` (default) or any numeric column. Ties break DETERMINISTIC:
  equal metric values order by (cell index, predictor position), so a
  re-run — or a different tile width — reproduces the same k rows in the
  same order.
- ``SummarySink`` — running first/second moments, min/max and counts per
  numeric column (Welford accumulation, no row retention) plus cell/row
  totals: the O(1)-memory answer for "what does the distribution of
  t-stats over a million cells look like".
- ``ParquetSink`` — spills each tile as a parquet (or CSV fallback when
  pyarrow is absent) part file and keeps only the manifest: the full-dump
  path for offline analysis of sweeps too big for any in-memory frame.

``resolve_sink`` maps the ``FMRP_SPECGRID_SINK`` / ``--specgrid-sink``
names to constructors.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

__all__ = [
    "Sink",
    "FrameSink",
    "TopKSink",
    "SummarySink",
    "ParquetSink",
    "resolve_sink",
    "resolve_sink_name",
    "SINK_NAMES",
]


class Sink:
    """Tile consumer protocol: ``consume`` per completed tile (in tile
    order), ``finish`` once → the sweep's result object. Sinks also count
    what passed through (``rows_seen``/``cells_seen``) so truncating sinks
    can disclose coverage."""

    rows_seen: int = 0
    cells_seen: int = 0

    def consume(self, tile_frame: pd.DataFrame) -> None:  # pragma: no cover
        raise NotImplementedError

    def finish(self) -> pd.DataFrame:  # pragma: no cover
        raise NotImplementedError

    def _count(self, tile_frame: pd.DataFrame) -> None:
        self.rows_seen += len(tile_frame)
        if "cell" in tile_frame:
            self.cells_seen += int(tile_frame["cell"].nunique())


class FrameSink(Sink):
    """Accumulate every tile; ``finish`` concatenates in arrival order.
    The materialized-result sink — only for grids whose frame fits."""

    def __init__(self) -> None:
        self._parts: List[pd.DataFrame] = []

    def consume(self, tile_frame: pd.DataFrame) -> None:
        self._count(tile_frame)
        self._parts.append(tile_frame)

    def finish(self) -> pd.DataFrame:
        if not self._parts:
            return pd.DataFrame()
        return pd.concat(self._parts, ignore_index=True)


class TopKSink(Sink):
    """Keep the k rows with the largest ``key(metric)`` seen so far.

    ``metric`` names a numeric column (default ``tstat``); ``absolute``
    ranks by magnitude (the "most significant anywhere" question). NaN
    metrics never enter the board. Determinism contract: rows sort by
    (-key, cell, predictor-position-within-cell), so ties — exact value
    collisions are common in bootstrap draws of the same cell — resolve by
    the cell's global address, independent of tile width or arrival
    timing."""

    def __init__(self, k: int = 100, metric: str = "tstat",
                 absolute: bool = True) -> None:
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = int(k)
        self.metric = metric
        self.absolute = bool(absolute)
        self._board: Optional[pd.DataFrame] = None

    def _keyed(self, frame: pd.DataFrame) -> pd.DataFrame:
        key = pd.to_numeric(frame[self.metric], errors="coerce")
        if self.absolute:
            key = key.abs()
        out = frame.assign(_key=key)
        return out[np.isfinite(out["_key"])]

    def consume(self, tile_frame: pd.DataFrame) -> None:
        self._count(tile_frame)
        if self.metric not in tile_frame.columns:
            raise KeyError(
                f"TopKSink metric {self.metric!r} not in tile columns "
                f"{list(tile_frame.columns)}"
            )
        fresh = self._keyed(tile_frame)
        board = (fresh if self._board is None
                 else pd.concat([self._board, fresh], ignore_index=True))
        # mergesort = stable; the frame arrives ordered by (cell, predictor
        # position), so equal keys keep that address order deterministically
        board = board.sort_values(
            ["_key", "cell"], ascending=[False, True], kind="mergesort"
        )
        self._board = board.head(self.k).reset_index(drop=True)

    def finish(self) -> pd.DataFrame:
        if self._board is None:
            return pd.DataFrame()
        return self._board.drop(columns=["_key"]).reset_index(drop=True)


class SummarySink(Sink):
    """Running per-column moments — O(#columns) memory however many cells
    stream through. Welford's update keeps the variance numerically stable
    over millions of rows; NaNs are excluded per column (pandas ``mean``
    semantics), with the NaN count disclosed."""

    def __init__(self) -> None:
        self._stats: Dict[str, Dict[str, float]] = {}

    def consume(self, tile_frame: pd.DataFrame) -> None:
        self._count(tile_frame)
        for col in tile_frame.columns:
            if not pd.api.types.is_numeric_dtype(tile_frame[col]):
                continue
            vals = tile_frame[col].to_numpy(dtype=float, copy=False)
            finite = np.isfinite(vals)
            s = self._stats.setdefault(col, {
                "count": 0.0, "nan_count": 0.0, "mean": 0.0, "m2": 0.0,
                "min": np.inf, "max": -np.inf,
            })
            s["nan_count"] += float((~finite).sum())
            batch = vals[finite]
            if batch.size == 0:
                continue
            # Chan/Welford pairwise merge of the tile's moments into the
            # running ones — O(tile) work, stable over million-row streams
            b_n = float(batch.size)
            b_mean = float(batch.mean())
            b_m2 = float(((batch - b_mean) ** 2).sum())
            total = s["count"] + b_n
            delta = b_mean - s["mean"]
            s["m2"] += b_m2 + delta * delta * s["count"] * b_n / total
            s["mean"] += delta * b_n / total
            s["count"] = total
            s["min"] = min(s["min"], float(batch.min()))
            s["max"] = max(s["max"], float(batch.max()))

    def finish(self) -> pd.DataFrame:
        rows = []
        for col, s in self._stats.items():
            cnt = s["count"]
            rows.append({
                "column": col,
                "count": int(cnt),
                "nan_count": int(s["nan_count"]),
                "mean": s["mean"] if cnt else np.nan,
                "std": float(np.sqrt(s["m2"] / (cnt - 1))) if cnt > 1 else np.nan,
                "min": s["min"] if cnt else np.nan,
                "max": s["max"] if cnt else np.nan,
            })
        return pd.DataFrame(rows)


class ParquetSink(Sink):
    """Spill each tile to ``<dir>/part-NNNNN.parquet`` (CSV fallback when
    pyarrow is missing — disclosed in the manifest) and keep only the
    part manifest in memory. ``finish`` returns the manifest frame."""

    def __init__(self, directory) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        # clear any previous sweep's parts: a shorter re-run would
        # otherwise leave stale high-numbered tiles mixed with fresh ones
        # for anyone globbing the directory instead of the manifest
        for stale in self.directory.glob("part-*"):
            if stale.suffix in (".parquet", ".csv"):
                stale.unlink()
        self._manifest: List[Dict[str, object]] = []
        try:
            import pyarrow  # noqa: F401

            self._format = "parquet"
        except Exception:  # pragma: no cover - container ships pyarrow
            self._format = "csv"

    def consume(self, tile_frame: pd.DataFrame) -> None:
        self._count(tile_frame)
        part = self.directory / (
            f"part-{len(self._manifest):05d}.{self._format}"
        )
        if self._format == "parquet":
            tile_frame.to_parquet(part, index=False)
        else:
            tile_frame.to_csv(part, index=False)
        self._manifest.append({
            "path": str(part),
            "format": self._format,
            "rows": len(tile_frame),
            "cells": int(tile_frame["cell"].nunique())
            if "cell" in tile_frame else len(tile_frame),
        })

    def finish(self) -> pd.DataFrame:
        return pd.DataFrame(self._manifest)


SINK_NAMES = ("frame", "topk", "summary", "parquet")


def resolve_sink_name(sink=None) -> str:
    """The EFFECTIVE sink name after env resolution — what callers gating
    on "is this the tidy full-frame schema?" must consult (checking the
    unresolved argument misses an env-selected sink)."""
    if isinstance(sink, Sink):
        return {
            FrameSink: "frame", TopKSink: "topk",
            SummarySink: "summary", ParquetSink: "parquet",
        }.get(type(sink), type(sink).__name__)
    name = sink or os.environ.get("FMRP_SPECGRID_SINK", "frame")
    if name not in SINK_NAMES:
        raise ValueError(f"unknown sink {name!r}; expected one of {SINK_NAMES}")
    return name


def resolve_sink(sink=None, output_dir=None, topk: int = 100):
    """Turn a sink NAME (or None, or an already-built ``Sink``) into a
    ``Sink``: argument wins, then ``FMRP_SPECGRID_SINK``, then "frame".
    "parquet" needs ``output_dir`` (the parts land in
    ``<output_dir>/specgrid_parts``)."""
    if isinstance(sink, Sink):
        return sink
    name = resolve_sink_name(sink)  # ONE name/env resolution + validation
    if name == "frame":
        return FrameSink()
    if name == "topk":
        return TopKSink(k=topk)
    if name == "summary":
        return SummarySink()
    if output_dir is None:
        raise ValueError("sink='parquet' needs an output directory")
    return ParquetSink(Path(output_dir) / "specgrid_parts")
