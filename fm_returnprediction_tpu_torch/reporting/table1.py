"""Table 1 — time-series averages of monthly cross-sectional statistics.

Same output contract as the reference's ``build_table_1``: MultiIndex
columns (subset, {Avg, Std, N}), one row per display variable, index name
``"Column"``.

Semantics:
- ±inf treated as missing;
- the monthly cross-sectional std is the sample std (ddof=1) — months with
  one observation contribute NaN and are skipped by the time-series average;
- Avg averages monthly means over months with ≥1 valid observation;
- N is the number of DISTINCT firms ever valid for the variable in the
  subset, not an average count.
"""

from __future__ import annotations

from typing import Dict

import pandas as pd
import torch

from fm_returnprediction_tpu_torch.panel.dense import DensePanel

__all__ = ["build_table_1", "table1_stats", "table1_stats_multi"]


def table1_stats(values: torch.Tensor, subset_mask: torch.Tensor):
    """Per-variable stats under one subset mask, two-pass variance.

    values: (T, N, K); subset_mask: (T, N) → (avg (K,), std (K,), n (K,)).
    The numerical reference for ``table1_stats_multi`` (the production
    route).
    """
    valid = subset_mask[:, :, None] & torch.isfinite(values)
    x = torch.where(valid, values, torch.zeros_like(values))
    cnt = valid.sum(dim=1)                                      # (T, K)
    cf = cnt.to(x.dtype)
    mean_t = x.sum(dim=1) / torch.clamp_min(cf, 1.0)

    # two-pass: the one-pass Σx² − n·mean² form cancels catastrophically
    # for near-constant cross-sections
    centered = torch.where(valid, values - mean_t[:, None, :], torch.zeros_like(values))
    var_t = (centered * centered).sum(dim=1) / torch.clamp_min(cf - 1.0, 1.0)
    std_t = torch.sqrt(var_t)

    has_mean = cnt >= 1
    has_std = cnt >= 2
    zeros = torch.zeros_like(mean_t)
    avg = (torch.where(has_mean, mean_t, zeros).sum(dim=0)
           / torch.clamp_min(has_mean.sum(dim=0), 1))
    std = (torch.where(has_std, std_t, zeros).sum(dim=0)
           / torch.clamp_min(has_std.sum(dim=0), 1))
    n_distinct = valid.any(dim=0).sum(dim=0)                    # (K,)
    nan = torch.full_like(avg, float("nan"))
    avg = torch.where(has_mean.sum(dim=0) > 0, avg, nan)
    std = torch.where(has_std.sum(dim=0) > 0, std, nan)
    return avg, std, n_distinct


def table1_stats_multi(values: torch.Tensor, stacked_masks: torch.Tensor):
    """All subsets' stats in one traversal of the (T, N, K) panel.

    values: (T, N, K); stacked_masks: (S, T, N) → (avg, std, n), each (S, K).

    The per-subset reductions over the firm axis are contractions
    (``stn,tnk->stk``, batched products over t), so nothing of shape
    (S, T, N, K) ever exists. Counts ride float32 contractions: the
    operands are 0/1 and the sums small integers (≤ N < 2^24), so they are
    exact. The moment contractions run in the data's dtype at full
    precision (no TF32).

    Variance uses the pivot-shifted one-pass form: with the per-month pivot
    ``c`` = mean over ALL finite firms (subset-independent) and
    ``d = x − c``, ``Σ_s (x − m_s)² = Σ_s d² − cnt_s·(m_s − c)²``; with the
    pivot inside one cross-sectional std of every subset mean the shift
    term is O(var) and the error stays a small multiple of eps.
    """
    finite = torch.isfinite(values)
    xz = torch.where(finite, values, torch.zeros_like(values))

    f32 = finite.to(torch.float32)
    cnt_all = f32.sum(dim=1)                                    # (T, K)
    c = xz.sum(dim=1) / torch.clamp_min(cnt_all, 1.0).to(xz.dtype)
    d = torch.where(finite, values - c[:, None, :], torch.zeros_like(values))

    masks_f32 = stacked_masks.to(torch.float32)
    masks_v = stacked_masks.to(d.dtype)
    cnt = torch.einsum("stn,tnk->stk", masks_f32, f32)          # (S, T, K)
    s1 = torch.einsum("stn,tnk->stk", masks_v, d)
    s2 = torch.einsum("stn,tnk->stk", masks_v, d * d)

    cf = cnt.to(d.dtype)
    shift = s1 / torch.clamp_min(cf, 1.0)                       # m_s − c
    mean_t = c[None] + shift
    var_t = (torch.clamp_min(s2 - cf * shift * shift, 0.0)
             / torch.clamp_min(cf - 1.0, 1.0))
    std_t = torch.sqrt(var_t)

    has_mean = cnt >= 1
    has_std = cnt >= 2
    zeros = torch.zeros_like(mean_t)
    avg = (torch.where(has_mean, mean_t, zeros).sum(dim=1)
           / torch.clamp_min(has_mean.sum(dim=1), 1))
    std = (torch.where(has_std, std_t, zeros).sum(dim=1)
           / torch.clamp_min(has_std.sum(dim=1), 1))
    # distinct firms ever valid: months-present count per (subset, firm,
    # variable), a contraction over the time axis, then count nonzeros
    ever = torch.einsum("stn,tnk->snk", masks_f32, f32)         # (S, N, K)
    n_distinct = (ever > 0).sum(dim=1)                          # (S, K)

    nan = torch.full_like(avg, float("nan"))
    avg = torch.where(has_mean.sum(dim=1) > 0, avg, nan)
    std = torch.where(has_std.sum(dim=1) > 0, std, nan)
    return avg, std, n_distinct


def build_table_1(
    panel: DensePanel,
    subset_masks: Dict[str, torch.Tensor],
    variables_dict: Dict[str, str],
) -> pd.DataFrame:
    """Assemble the reference-layout Table 1 DataFrame from one
    ``table1_stats_multi`` call and one host pull."""
    values = panel.select(list(variables_dict.values()))
    stacked = torch.stack([torch.as_tensor(m, device=values.device)
                           for m in subset_masks.values()])
    avg, std, n = (a.cpu().numpy() for a in table1_stats_multi(values, stacked))

    partials = []
    for si, subset_name in enumerate(subset_masks):
        partial = pd.DataFrame(
            {"Avg": avg[si], "Std": std[si], "N": n[si]},
            index=list(variables_dict.keys()),
        )
        partial.columns = pd.MultiIndex.from_product([[subset_name], partial.columns])
        partials.append(partial)

    table = pd.concat(partials, axis=1)
    table.index.name = "Column"
    return table
