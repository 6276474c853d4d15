"""NYSE-breakpoint stock universes as subset masks.

A universe is a (T, N) boolean mask over the shared panel: all stocks,
all-but-tiny (market equity at or above the monthly 20th percentile of
NYSE market equity) and large (at or above the NYSE median). Breakpoints
are pandas linear-interpolated quantiles; a month with no NYSE stocks has
NaN breakpoints, so its rows drop out of the two filtered universes.
``flag_firms_missing_variables`` is the reference's Table 1 firm filter
(dead code on its main path, kept for the API).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fm_returnprediction_tpu_torch.ops.quantiles import masked_quantile
from fm_returnprediction_tpu_torch.panel.dense import DensePanel

__all__ = ["SUBSET_ORDER", "compute_subset_masks", "flag_firms_missing_variables"]

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


def flag_firms_missing_variables(
    panel: DensePanel, needed_vars=("retx", "log_size", "log_bm", "return_12_2")
) -> set:
    """Firms with at least one required variable missing on every one of
    their observed rows (the reference's ``filter_companies_table1``), as a
    set of ids: one reduction over the time axis. Device values are copied
    to the host first."""
    vals = panel.select(list(needed_vars))           # (T, N, V)
    if isinstance(vals, torch.Tensor):
        vals = vals.detach().cpu().numpy()
    mask = np.asarray(panel.mask)
    has_value = np.isfinite(vals) & mask[:, :, None]  # observed & non-missing
    any_value = has_value.any(axis=0)                 # (N, V)
    flagged = mask.any(axis=0) & (~any_value).any(axis=1)
    return set(np.asarray(panel.ids)[flagged].tolist())
