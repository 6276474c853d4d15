"""The dense firm-month panel.

``T`` indexes the observed months (sorted unique), ``N`` firm slots (one per
permno), ``K`` the variables. Firm-months absent from the source are masked
out and hold NaN. Pandas' row-shift semantics are reproduced downstream by
compacting each firm's observed rows (``ops.compaction``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = ["DensePanel"]


@dataclasses.dataclass
class DensePanel:
    """A dense firm-month panel.

    Attributes
    ----------
    values : (T, N, K) float, NaN where absent/missing. A host numpy array
             (the prepared base panel) or a torch tensor on the compute
             device (the enriched pipeline panel).
    mask   : (T, N) bool numpy array, True where the firm-month row exists.
    months : (T,) datetime64[ns], sorted unique observation dates.
    ids    : (N,) firm identifiers (permno order = column order).
    var_names : list of K variable names (K axis order).
    """

    values: object
    mask: np.ndarray
    months: np.ndarray
    ids: np.ndarray
    var_names: List[str]

    @property
    def shape(self) -> tuple:
        return tuple(self.values.shape)

    def var_index(self, name: str) -> int:
        return self.var_names.index(name)

    def var(self, name: str):
        """The (T, N) slice for one variable."""
        return self.values[:, :, self.var_index(name)]

    def select(self, names: Sequence[str]):
        """The (T, N, len(names)) sub-array in the given variable order."""
        idx = [self.var_index(n) for n in names]
        return self.values[:, :, idx]
