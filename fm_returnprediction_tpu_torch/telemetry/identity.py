"""Per-process telemetry identity: the ``process_index`` label.

One process's metrics and traces are self-describing; N processes'
merged exports are not: a Prometheus scrape of four workers or a
directory of four ``events.jsonl`` files needs every sample to say WHICH
process produced it. This module is the one home of that answer:

- ``process_index()``: the process's rank, or None (single process, the
  plain export);
- set explicitly with :func:`set_process_index`, or ambiently through
  ``FMRP_PROC_INDEX`` (a replica child) or ``FMRP_DIST_PROC_ID`` (an
  exchange worker), the reference package's variables.

Consumers: ``metrics.MetricsRegistry.to_prometheus`` stamps
``process_index="k"`` onto every exported series, ``export.write_jsonl``
carries it in the meta header, and the Chrome trace names the process
row ``fmrp-host[pK]``, all ONLY when armed, so single-process exports
stay byte-identical to an unarmed run's.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["process_index", "set_process_index", "process_suffix"]

_EXPLICIT: Optional[int] = None


def set_process_index(index: Optional[int]) -> None:
    """Pin this process's identity; ``None`` disarms it again."""
    global _EXPLICIT
    _EXPLICIT = None if index is None else int(index)


def process_index() -> Optional[int]:
    """The process's rank for export labels, or None when single-process.

    Precedence: explicit :func:`set_process_index` > ``FMRP_PROC_INDEX``
    > ``FMRP_DIST_PROC_ID``. Read live on every call."""
    if _EXPLICIT is not None:
        return _EXPLICIT
    for var in ("FMRP_PROC_INDEX", "FMRP_DIST_PROC_ID"):
        raw = os.environ.get(var, "").strip()
        if raw:
            try:
                return int(raw)
            except ValueError:
                continue
    return None


def process_suffix() -> str:
    """``"[pK]"`` when armed, ``""`` otherwise (trace process names)."""
    idx = process_index()
    return f"[p{idx}]" if idx is not None else ""
