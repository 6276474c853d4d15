"""Streaming sinks for backtest sweeps — the spec-grid sink family plus the
O(1) ``metrics`` aggregate.

A backtest tile frame has ONE ROW PER CELL (``oos_r2``,
``ic_mean``/``ic_tstat``, ``spread``/``spread_tstat``, ``spread_turnover``,
…), and the spec-grid sinks are schema-agnostic tile consumers:

- ``frame`` / ``summary`` / ``parquet`` — as in the spec grid (parquet
  parts land in ``<output_dir>/backtest_parts``);
- ``topk`` — the leaderboard ranks by ``spread_tstat`` magnitude;
- ``metrics`` — running Welford moments of every headline metric per
  (scheme, weighting) group and each group's best cell by
  ``|spread_tstat|`` (ties → the lower cell index): O(groups · metrics)
  memory however many cells stream through.

``resolve_backtest_sink`` maps the ``sink`` argument or
``FMRP_BACKTEST_SINK`` onto a sink (argument > env > ``"frame"``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import numpy as np
import pandas as pd

from fm_returnprediction_tpu_torch.specgrid.sinks import (
    FrameSink,
    ParquetSink,
    Sink,
    SummarySink,
    TopKSink,
    resolve_sink_name,
)

__all__ = [
    "BACKTEST_SINK_NAMES",
    "MetricsSink",
    "resolve_backtest_sink",
    "resolve_backtest_sink_name",
]

BACKTEST_SINK_NAMES = ("frame", "topk", "summary", "parquet", "metrics")

#: headline metrics the aggregate sink tracks (when present in the tile)
METRIC_COLUMNS = ("oos_r2", "ic_mean", "ic_tstat", "rank_ic_mean", "rank_ic_tstat",
                  "spread", "spread_tstat", "spread_turnover")


def _float(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


class MetricsSink(Sink):
    """Per-(scheme, weighting) running moments + best cell, O(1) in the
    cell count. ``finish`` returns one row per group with each metric's
    mean/std over the group's cells, the group's best cell index and its
    ``spread_tstat`` (by magnitude, ties by cell index)."""

    def __init__(self) -> None:
        self._groups: Dict[tuple, Dict[str, Dict[str, float]]] = {}
        self._best: Dict[tuple, Dict[str, object]] = {}
        self._cells: Dict[tuple, int] = {}

    def consume(self, tile_frame: pd.DataFrame) -> None:
        self._count(tile_frame)
        for row in tile_frame.to_dict("records"):
            key = (row.get("scheme", ""), row.get("weighting", ""))
            self._cells[key] = self._cells.get(key, 0) + 1
            stats = self._groups.setdefault(key, {})
            for col in METRIC_COLUMNS:
                val = _float(row.get(col, np.nan))
                if val is None or not np.isfinite(val):
                    continue
                s = stats.setdefault(col, {"count": 0.0, "mean": 0.0, "m2": 0.0})
                s["count"] += 1.0
                delta = val - s["mean"]
                s["mean"] += delta / s["count"]
                s["m2"] += delta * (val - s["mean"])
            tstat = _float(row.get("spread_tstat", np.nan))
            if tstat is None or not np.isfinite(tstat):
                continue
            mag, cell = abs(tstat), int(row.get("cell", -1))
            best = self._best.get(key)
            if best is None or mag > best["mag"] or (mag == best["mag"] and cell < best["cell"]):
                self._best[key] = {"mag": mag, "cell": cell, "tstat": tstat}

    def finish(self) -> pd.DataFrame:
        rows = []
        for key in sorted(self._cells):
            scheme, weighting = key
            out = {"scheme": scheme, "weighting": weighting, "cells": self._cells[key]}
            stats = self._groups.get(key, {})
            for col in METRIC_COLUMNS:
                s = stats.get(col)
                cnt = s["count"] if s else 0.0
                out[f"{col}_mean"] = s["mean"] if cnt else np.nan
                out[f"{col}_std"] = float(np.sqrt(s["m2"] / (cnt - 1))) if cnt > 1 else np.nan
            best = self._best.get(key)
            out["best_cell"] = best["cell"] if best else -1
            out["best_spread_tstat"] = best["tstat"] if best else np.nan
            rows.append(out)
        return pd.DataFrame(rows)


def resolve_backtest_sink_name(sink=None) -> str:
    """The effective backtest sink name: argument > ``FMRP_BACKTEST_SINK``
    > ``"frame"``."""
    if isinstance(sink, Sink):
        return "metrics" if isinstance(sink, MetricsSink) else resolve_sink_name(sink)
    name = sink or os.environ.get("FMRP_BACKTEST_SINK", "frame")
    if name not in BACKTEST_SINK_NAMES:
        raise ValueError(f"unknown backtest sink {name!r}; expected one of "
                         f"{BACKTEST_SINK_NAMES}")
    return name


def resolve_backtest_sink(sink=None, output_dir=None, topk: int = 20) -> Sink:
    """A backtest sink from a NAME (or None, or a built ``Sink``): ``topk``
    ranks by ``|spread_tstat|``; ``parquet`` needs ``output_dir`` (parts in
    ``<output_dir>/backtest_parts``)."""
    if isinstance(sink, Sink):
        return sink
    name = resolve_backtest_sink_name(sink)
    if name == "frame":
        return FrameSink()
    if name == "topk":
        return TopKSink(k=topk, metric="spread_tstat")
    if name == "summary":
        return SummarySink()
    if name == "metrics":
        return MetricsSink()
    if output_dir is None:
        raise ValueError("sink='parquet' needs an output directory")
    return ParquetSink(Path(output_dir) / "backtest_parts")
