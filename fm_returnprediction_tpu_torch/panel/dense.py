"""The dense firm-month panel.

``T`` indexes the observed months (sorted unique), ``N`` firm slots (one per
permno), ``K`` the variables. Firm-months absent from the source are masked
out and hold NaN. Pandas' row-shift semantics are reproduced downstream by
compacting each firm's observed rows (``ops.compaction``).
``long_to_dense`` packs a long firm-month frame into this layout on the host
and ``dense_to_long`` unpacks it; ``DensePanel.save``/``load`` checkpoint it between the task graph's
``build_panel`` stage and the stages that read it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Sequence

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.device import resolve_device

__all__ = ["DensePanel", "long_to_dense", "dense_to_long"]


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

    def save(self, path) -> None:
        """Checkpoint the panel as one compressed npz of host arrays, the
        reference package's format (the same keys, so either package loads
        the other's file): ``values``, ``mask``, ``months`` (int64
        nanoseconds), ``ids`` and ``var_names`` (fixed-width unicode, so
        the file loads with ``allow_pickle`` off). A device tensor is
        copied to the host first. The write is atomic: a crash leaves the
        old file or none."""
        from fm_returnprediction_tpu_torch.utils.cache import _atomic_replace

        values = self.values
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        path = Path(path)
        if path.suffix != ".npz":
            path = Path(str(path) + ".npz")  # where np.savez would write it
        with _atomic_replace(path) as tmp:
            np.savez_compressed(
                tmp,
                values=values,
                mask=np.asarray(self.mask),
                months=np.asarray(self.months).astype("datetime64[ns]").astype(np.int64),
                ids=np.asarray(self.ids),
                var_names=np.asarray(self.var_names, dtype=np.str_),
            )

    @classmethod
    def load(cls, path, device=None) -> "DensePanel":
        """A panel saved by either package, its values a tensor on
        ``device`` (default the GPU; raises without one) in the file's
        dtype; the mask, months and ids stay host numpy."""
        device = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            values = torch.from_numpy(z["values"]).to(device)
            return cls(
                values=values,
                mask=z["mask"],
                months=z["months"].astype("datetime64[ns]"),
                ids=z["ids"],
                var_names=[str(v) for v in z["var_names"]],
            )


def long_to_dense(
    df: pd.DataFrame,
    date_col: str,
    id_col: str,
    value_cols: Sequence[str],
    dtype=np.float64,
) -> DensePanel:
    """Pack a long firm-month frame into a host-numpy ``DensePanel``
    (``dtype`` a numpy dtype). Duplicate (id, date) rows keep the last
    occurrence (the reference's keep-last merge convention)."""
    months, t_idx = np.unique(df[date_col].to_numpy(), return_inverse=True)
    ids, n_idx = np.unique(df[id_col].to_numpy(), return_inverse=True)

    t, n, k = len(months), len(ids), len(value_cols)
    values = np.full((t, n, k), np.nan, dtype=dtype)
    mask = np.zeros((t, n), dtype=bool)

    data = df[list(value_cols)].to_numpy(dtype=dtype)
    values[t_idx, n_idx, :] = data  # later duplicates overwrite earlier ones
    mask[t_idx, n_idx] = True

    return DensePanel(
        values=values,
        mask=mask,
        months=pd.DatetimeIndex(months).values,
        ids=ids,
        var_names=list(value_cols),
    )


def dense_to_long(panel: DensePanel) -> pd.DataFrame:
    """Unpack a ``DensePanel`` back into a long frame of its existing rows
    (``date``, ``id`` and one column per variable; the inverse of
    ``long_to_dense`` up to row order). Device values are copied to the
    host first."""
    values = panel.values
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    t_idx, n_idx = np.nonzero(np.asarray(panel.mask))
    out = {
        "date": pd.DatetimeIndex(panel.months)[t_idx],
        "id": np.asarray(panel.ids)[n_idx],
    }
    for k, name in enumerate(panel.var_names):
        out[name] = values[t_idx, n_idx, k]
    return pd.DataFrame(out)
