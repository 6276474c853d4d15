"""NYSE-breakpoint stock universes as subset masks.

A universe is a (T, N) boolean mask over the shared panel: all stocks,
all-but-tiny (market equity at or above the monthly 20th percentile of
NYSE market equity) and large (at or above the NYSE median). Breakpoints
are pandas linear-interpolated quantiles; a month with no NYSE stocks has
NaN breakpoints, so its rows drop out of the two filtered universes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fm_returnprediction_tpu_torch.ops.quantiles import masked_quantile
from fm_returnprediction_tpu_torch.panel.dense import DensePanel

__all__ = ["SUBSET_ORDER", "compute_subset_masks"]

SUBSET_ORDER = ["All stocks", "All-but-tiny stocks", "Large stocks"]


def compute_subset_masks(panel: DensePanel) -> Dict[str, torch.Tensor]:
    """(T, N) boolean masks for the three universes, on the device of the
    panel's values. Needs panel variables ``me`` and ``is_nyse``."""
    me = torch.as_tensor(panel.var("me"))
    mask = torch.tensor(np.asarray(panel.mask), device=me.device)
    is_nyse = torch.as_tensor(panel.var("is_nyse"), device=me.device)
    nyse = mask & (is_nyse > 0)
    breakpoints = masked_quantile(me, nyse, [0.2, 0.5])
    me_20, me_50 = breakpoints[:, 0][:, None], breakpoints[:, 1][:, None]
    return {
        "All stocks": mask,
        "All-but-tiny stocks": mask & (me >= me_20),
        "Large stocks": mask & (me >= me_50),
    }
