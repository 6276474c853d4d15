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

Tensor design: daily rows → weekly partial sums by ``index_add_`` over the
week ids, 156-week FORWARD windowed sums by reversed cumulative-sum
difference, then a per-month max-reduction picks the last valid week.
Everything is per-firm independent along N.
"""

from __future__ import annotations

import torch

from fm_returnprediction_tpu_torch.ops.rolling import windowed_sum

__all__ = [
    "last_obs_per_month",
    "weekly_partial_sums",
    "beta_from_weekly_sums",
    "weekly_rolling_beta_monthly",
]


def _forward_windowed_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sum over [j, j+window) along axis 0: reverse, trailing-window sum,
    reverse."""
    return torch.flip(windowed_sum(torch.flip(x, (0,)), window), (0,))


def _segment_sum(a: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    out = torch.zeros((n_seg,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    return out.index_add_(0, seg, a)


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


def weekly_partial_sums(ret_d, mask_d, mkt_d, week_id, n_weeks: int,
                        mkt_present=None):
    """Daily rows → the six weekly partial-sum tensors (n_weeks, N).

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

    seg = week_id.to(torch.int64)
    w_ri = _segment_sum(log_ri, seg, n_weeks)
    w_rm = _segment_sum(log_rm, seg, n_weeks)
    w_rirm = _segment_sum(torch.where(ri_valid & rm_valid, log_ri * log_rm, zero),
                          seg, n_weeks)
    w_rm2 = _segment_sum(log_rm * log_rm, seg, n_weeks)
    w_cnt = _segment_sum(present.to(ret_d.dtype), seg, n_weeks)
    w_rm_cnt = _segment_sum(rm_valid.to(ret_d.dtype), seg, n_weeks)
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
    ret_d, mask_d, mkt_d, week_id, n_weeks: int, week_month_id, n_months: int,
    window_weeks: int = 156, mkt_present=None,
) -> torch.Tensor:
    """Rolling beta on the weekly Monday lattice, one value per
    (month, firm); NaN where no valid window start falls in the month."""
    sums = weekly_partial_sums(ret_d, mask_d, mkt_d, week_id, n_weeks,
                               mkt_present=mkt_present)
    return beta_from_weekly_sums(*sums, week_month_id, n_months, window_weeks)
