"""Per-firm time compaction — pandas row semantics on dense tensors.

The reference computes every lag and rolling window with pandas
``groupby("permno").shift/rolling`` on row-sorted long frames. Those are ROW
operations: a firm with a month gap sees its previous *row*, which may be
several calendar months earlier. On the dense ``(T, N)`` panel the
equivalent is: stably compact each firm's observed rows to the front of the
time axis, run the window op on the compacted axis, and scatter results back
to the original slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Compaction", "make_compaction", "compact", "scatter_back", "lag"]


class Compaction(NamedTuple):
    """Reusable per-firm compaction plan for one (T, N) mask."""

    order: torch.Tensor      # (T, N) row permutation putting valid rows first
    inv_order: torch.Tensor  # (T, N) inverse permutation
    count: torch.Tensor      # (N,) valid rows per firm
    valid: torch.Tensor      # (T, N) bool: compacted slot j < count[n]
    mask: torch.Tensor       # (T, N) original mask


def make_compaction(mask: torch.Tensor) -> Compaction:
    """Build the compaction plan for a (T, N) validity mask. The stable sort
    keeps each firm's rows in chronological order (the reference's
    ``sort_values(["permno", "mthcaldt"])``)."""
    order = torch.argsort((~mask).to(torch.uint8), dim=0, stable=True)
    ramp = torch.arange(mask.shape[0], device=mask.device)
    inv_order = torch.empty_like(order).scatter_(
        0, order, ramp[:, None].expand_as(order).contiguous()
    )
    count = mask.sum(dim=0)
    valid = ramp[:, None] < count[None, :]
    return Compaction(order, inv_order, count, valid, mask)


def compact(values: torch.Tensor, plan: Compaction) -> torch.Tensor:
    """Gather a (T, N) variable into compacted row order (invalid tail slots
    hold whatever the masked-out rows held; gate on ``plan.valid``)."""
    return torch.gather(values, 0, plan.order)


def scatter_back(comp_values: torch.Tensor, plan: Compaction,
                 fill=float("nan")) -> torch.Tensor:
    """Inverse of :func:`compact`: place compacted-row results back at their
    original calendar slots; absent rows get ``fill``."""
    out = torch.gather(comp_values, 0, plan.inv_order)
    return torch.where(plan.mask, out, torch.full_like(out, fill))


def lag(comp_values: torch.Tensor, k: int, fill=float("nan")) -> torch.Tensor:
    """Row-shift by ``k`` on the compacted axis — the dense equivalent of
    ``groupby("permno")[col].shift(k)``. The first ``k`` compacted slots of
    each firm become ``fill``."""
    if k == 0:
        return comp_values
    t = comp_values.shape[0]
    pad = torch.full((k,) + tuple(comp_values.shape[1:]), fill,
                     dtype=comp_values.dtype, device=comp_values.device)
    return torch.cat([pad, comp_values[: max(t - k, 0)]], dim=0)[:t]
