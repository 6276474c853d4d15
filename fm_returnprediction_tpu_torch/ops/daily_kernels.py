"""Daily-data building blocks: last observation per month and the
weekly-grid rolling beta.

Rolling beta (reference ``calculate_rolling_beta``): the reference
inner-joins daily stock and index returns, takes log gross returns, and
runs polars ``group_by_dynamic(every="1w", period="156w", by="permno")`` to
get rolling partial sums, from which
``beta = (ΣRiRm − ΣRiΣRm/n)/(ΣRm² − (ΣRm)²/n)``. The window semantics kept
here: window starts lie on the global Monday lattice; each window is
label-LEFT and forward, ``[start, start + 156 weeks)``; per firm, windows
are emitted for week-starts from its first to its last observation week;
the weekly rows are stamped with the month-end of the window START and
deduplicated keep-last per (firm, month).

Tensor design: daily rows → weekly partial sums by a segment sum over the
week lengths (days per week, the calendar's nondecreasing week ids counted
once on the host), 156-week FORWARD windowed sums by reversed
cumulative-sum difference, then a per-month max-reduction picks the last
valid week. Everything is per-firm independent along N. The segment sum
adds each week's rows in day order on every device (``index_add_`` on the
card adds them with atomics in whatever order the threads run), so the
card gives the same bits from run to run and the CPU the bits of a
sequential scatter-add.
"""

from __future__ import annotations

import torch

from fm_returnprediction_tpu_torch.ops.compaction import compact, make_compaction, scatter_back
from fm_returnprediction_tpu_torch.ops.rolling import rolling_std, windowed_sum

__all__ = [
    "rolling_vol_252_monthly",
    "last_obs_per_month",
    "segment_sum",
    "weekly_partial_sums",
    "beta_from_weekly_sums",
    "weekly_rolling_beta_monthly",
]


def _forward_windowed_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sum over [j, j+window) along axis 0: reverse, trailing-window sum,
    reverse."""
    return torch.flip(windowed_sum(torch.flip(x, (0,)), window), (0,))


def segment_sum(a: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Row sums of ``a`` over consecutive segments of ``lengths`` rows
    (summing to ``a.shape[0]``); rows added in order, an empty segment sums
    to 0."""
    return torch.segment_reduce(a, "sum", lengths=lengths, axis=0, unsafe=True)


def last_obs_per_month(
    values: torch.Tensor,
    present: torch.Tensor,
    month_id: torch.Tensor,
    n_months: int,
) -> torch.Tensor:
    """Per (month, firm): the value at the firm's LAST present row of that
    month — ``drop_duplicates(['permno','jdate'], keep='last')`` on
    row-sorted daily data.

    values (D, N); present (D, N) bool; month_id (D,) int in [0, n_months],
    where ``n_months`` is a trash segment. Returns (n_months, N), NaN where a
    firm has no row in a month.
    """
    d, n = values.shape
    day_pos = torch.arange(d, device=values.device)[:, None].expand(d, n)
    pos = torch.where(present, day_pos, torch.full_like(day_pos, -1))
    last = torch.full((n_months + 1, n), -1, dtype=pos.dtype, device=pos.device)
    last.scatter_reduce_(0, month_id.to(torch.int64)[:, None].expand(d, n), pos,
                         reduce="amax", include_self=True)
    last = last[:n_months]
    picked = torch.gather(values, 0, torch.clamp_min(last, 0))
    return torch.where(last >= 0, picked, torch.full_like(picked, float("nan")))


def rolling_vol_252_monthly(ret_d, mask_d, month_id, n_months: int, window: int = 252,
                            min_periods: int = 100) -> torch.Tensor:
    """Annualized ``window``-row rolling std of daily returns (pandas' per-firm
    ROW window: each firm's present rows compacted to the front), sampled
    at each firm-month's last present day; (n_months, N) from the dense
    (D, N) layout. The roll is ``rolling_std``: the rolling kernel on a CUDA
    tensor."""
    plan = make_compaction(mask_d)
    comp_ret = torch.where(plan.valid, compact(ret_d, plan),
                           torch.full_like(ret_d, float("nan")))
    scale = torch.sqrt(torch.tensor(float(window), dtype=ret_d.dtype, device=ret_d.device))
    vol = rolling_std(comp_ret, window, min_periods) * scale
    return last_obs_per_month(scatter_back(vol, plan), mask_d, month_id, n_months)


def weekly_partial_sums(ret_d, mask_d, mkt_d, week_lengths, mkt_present=None):
    """Daily rows → the six weekly partial-sum tensors (n_weeks, N);
    ``week_lengths`` (n_weeks,) int64 counts the days of each week.

    NaN returns follow the reference's polars semantics: aggregate sums
    skip nulls, while ``pl.count()`` counts ALL rows; days the index table
    lacks (``mkt_present`` False) are dropped by the reference's inner join.
    """
    if mkt_present is None:
        mkt_present = torch.isfinite(mkt_d)
    present = mask_d & mkt_present[:, None]
    ri_valid = present & torch.isfinite(ret_d)
    rm_valid = present & torch.isfinite(mkt_d)[:, None]
    zero = torch.zeros((), dtype=ret_d.dtype, device=ret_d.device)
    log_ri = torch.where(ri_valid, torch.log1p(ret_d), zero)
    log_rm = torch.where(rm_valid, torch.log1p(mkt_d)[:, None], zero)

    w_ri = segment_sum(log_ri, week_lengths)
    w_rm = segment_sum(log_rm, week_lengths)
    w_rirm = segment_sum(torch.where(ri_valid & rm_valid, log_ri * log_rm, zero),
                         week_lengths)
    w_rm2 = segment_sum(log_rm * log_rm, week_lengths)
    w_cnt = segment_sum(present.to(ret_d.dtype), week_lengths)
    w_rm_cnt = segment_sum(rm_valid.to(ret_d.dtype), week_lengths)
    return w_ri, w_rm, w_rirm, w_rm2, w_cnt, w_rm_cnt


def beta_from_weekly_sums(w_ri, w_rm, w_rirm, w_rm2, w_cnt, w_rm_cnt,
                          week_month_id, n_months: int, window_weeks: int):
    """Weekly partial sums (n_weeks, N) → (n_months, N) betas."""
    s_ri = _forward_windowed_sum(w_ri, window_weeks)
    s_rm = _forward_windowed_sum(w_rm, window_weeks)
    s_rirm = _forward_windowed_sum(w_rirm, window_weeks)
    s_rm2 = _forward_windowed_sum(w_rm2, window_weeks)
    n = _forward_windowed_sum(w_cnt, window_weeks)
    n_rm = _forward_windowed_sum(w_rm_cnt, window_weeks)

    n_safe = torch.clamp_min(n, 1.0)
    cov = s_rirm - s_ri * s_rm / n_safe
    var = s_rm2 - s_rm * s_rm / n_safe
    # windows whose cov and var are exactly zero in real arithmetic (n <= 1,
    # or no row carries a market return) give 0/0 = null in polars; gate
    # them, since the cumulative-sum difference leaves tiny residuals there
    beta = torch.where((n >= 2.0) & (n_rm >= 1.0), cov / var,
                       torch.full_like(cov, float("nan")))

    nw = w_cnt.shape[0]
    week_pos = torch.arange(nw, device=w_cnt.device)[:, None]
    has = w_cnt > 0
    first = torch.where(has, week_pos, torch.full_like(week_pos, nw)).amin(dim=0)
    last = torch.where(has, week_pos, torch.full_like(week_pos, -1)).amax(dim=0)
    win_valid = (week_pos >= first[None, :]) & (week_pos <= last[None, :]) & (n >= 1)
    return last_obs_per_month(beta, win_valid, week_month_id, n_months)


def weekly_rolling_beta_monthly(
    ret_d, mask_d, mkt_d, week_lengths, week_month_id, n_months: int,
    window_weeks: int = 156, mkt_present=None,
) -> torch.Tensor:
    """Rolling beta on the weekly Monday lattice, one value per
    (month, firm); NaN where no valid window start falls in the month."""
    sums = weekly_partial_sums(ret_d, mask_d, mkt_d, week_lengths,
                               mkt_present=mkt_present)
    return beta_from_weekly_sums(*sums, week_month_id, n_months, window_weeks)
