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

from fm_returnprediction_tpu_torch.ops.rolling import rolling_mean

__all__ = ["Compaction", "make_compaction", "compact", "scatter_back", "lag",
           "rolling_over_valid_rows"]


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


def rolling_over_valid_rows(values: torch.Tensor, valid: torch.Tensor,
                            window: int, min_periods: int, row_lag: int = 0,
                            fill_invalid: bool = False) -> torch.Tensor:
    """Rolling mean over the SURVIVING rows of a (T, K) series, scattered
    back to calendar slots.

    Figure 1's 120-month slope means roll over consecutive surviving
    months (the slope frame's rows), and the out-of-sample forecast's
    lagged coefficient means do the same: stably compact rows where
    ``valid`` (T,) holds to the front, roll over the compacted axis,
    optionally shift by ``row_lag`` rows (strictly-prior information), and
    scatter back, NaN at invalid calendar slots.

    ``fill_invalid=True`` (requires ``row_lag > 0``) instead gives EVERY
    slot the lagged mean its position would see: for an invalid slot, the
    window ending at the last surviving row before it. At surviving slots
    the two modes agree exactly.

    Leading batch axes are allowed — values (..., T, K), valid (..., T) —
    and every series rolls in ONE ``rolling_mean`` call over a (T, B·K)
    layout (one kernel launch on the card).
    """
    if fill_invalid and not row_lag:
        raise ValueError("fill_invalid requires row_lag > 0")
    t = valid.shape[-1]
    ramp = torch.arange(t, device=valid.device)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    comp = torch.gather(values, -2, order[..., None].expand(values.shape))
    in_range = ramp < valid.sum(-1, keepdim=True)
    comp = torch.where(in_range[..., None], comp, torch.full_like(comp, float("nan")))
    time_major = comp.movedim(-2, 0)                       # (T, ..., K)
    rolled = rolling_mean(time_major.reshape(t, -1), window, min_periods)
    rolled = rolled.reshape(time_major.shape).movedim(0, -2)
    if row_lag:
        pad = torch.full(rolled.shape[:-2] + (row_lag, rolled.shape[-1]),
                         float("nan"), dtype=rolled.dtype, device=rolled.device)
        rolled = torch.cat([pad, rolled[..., : max(t - row_lag, 0), :]], dim=-2)[..., :t, :]
    if fill_invalid:
        # surviving rows strictly before each slot == the compacted index
        # the slot's lagged window ends at
        k = torch.cumsum(valid.to(torch.int64), dim=-1) - valid.to(torch.int64)
        return torch.gather(rolled, -2, k[..., None].expand(rolled.shape))
    inv_order = torch.argsort(order, dim=-1, stable=True)
    back = torch.gather(rolled, -2, inv_order[..., None].expand(rolled.shape))
    return torch.where(valid[..., None], back, torch.full_like(back, float("nan")))
