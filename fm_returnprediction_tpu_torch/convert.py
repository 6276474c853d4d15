"""Carry prepared inputs over from another producer.

``prepared_from_numpy`` reads a dense base panel and compacted daily strips
by attribute (any objects with the fields below, e.g. a prepared-inputs
checkpoint written by the JAX package) and builds the port's own
dataclasses with host numpy arrays. It imports nothing of the producer.
"""

from __future__ import annotations

import numpy as np

from fm_returnprediction_tpu_torch.panel.daily import CompactDaily
from fm_returnprediction_tpu_torch.panel.dense import DensePanel

__all__ = ["prepared_from_numpy"]

_DAILY_FIELDS = ("row_values", "row_pos", "offsets", "ids", "mkt",
                 "mkt_present", "days", "day_month_id", "week_id",
                 "week_month_id")


def prepared_from_numpy(dense_base, compact_daily):
    """``(DensePanel, CompactDaily)`` of the port from objects exposing
    ``values``/``mask``/``months``/``ids``/``var_names`` and the compact
    daily fields (``row_values`` … ``n_months``)."""
    panel = DensePanel(
        values=np.asarray(dense_base.values),
        mask=np.asarray(dense_base.mask, dtype=bool),
        months=np.asarray(dense_base.months),
        ids=np.asarray(dense_base.ids),
        var_names=[str(v) for v in dense_base.var_names],
    )
    daily = CompactDaily(
        **{f: np.asarray(getattr(compact_daily, f)) for f in _DAILY_FIELDS},
        n_weeks=int(compact_daily.n_weeks),
        n_months=int(compact_daily.n_months),
    )
    return panel, daily
