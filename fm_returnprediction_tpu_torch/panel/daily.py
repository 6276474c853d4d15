"""Daily data in per-firm compacted (CSR-like) layout (host numpy).

Each firm's observed rows in chronological order, flattened firm-major,
with int day positions into the shared trading-day vocabulary, plus the
per-day calendar vectors the daily kernels need: month index of each day
(out-of-vocabulary months map to the trash segment ``n_months``) and the
Monday-lattice week index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CompactDaily"]


@dataclasses.dataclass
class CompactDaily:
    """Daily data in per-firm compacted layout; the payload the chunked
    strip loop (``ops.daily_chunked``) slices into strips."""

    row_values: np.ndarray     # (R,) retx rows, firm-major chronological
    row_pos: np.ndarray        # (R,) day index; int16 when n_days < 32768
    offsets: np.ndarray        # (N+1,) int64 firm row ranges
    ids: np.ndarray            # (N,) permnos (sorted, same vocab as dense)
    mkt: np.ndarray            # (D,) market return (vwretx)
    mkt_present: np.ndarray    # (D,) bool, index table has the day
    days: np.ndarray           # (D,) datetime64 trading-day vocabulary
    day_month_id: np.ndarray   # (D,) month index (trash=n_months)
    week_id: np.ndarray        # (D,) Monday-lattice week index
    n_weeks: int
    week_month_id: np.ndarray  # (n_weeks,) month index of each week's Monday
    n_months: int

    @property
    def n_days(self) -> int:
        return len(self.days)

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)
