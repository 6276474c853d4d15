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
days regrouped by one stable sort of their week ids (any order; the
calendar's days are already in week order and keep it; ids outside
``[0, n_weeks)`` are dropped), 156-week FORWARD windowed sums by reversed
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


def _week_runs(week_id, n_weeks: int, device):
    """The days regrouped week by week for ordered sums: ``order`` (D,), a
    stable sort of the days by week id, and ``lengths`` (n_weeks + 1,), the
    days of each week; the last run holds the days whose id lies outside
    ``[0, n_weeks)``, which the sums drop (as the reference's
    ``segment_sum`` drops them). Days in calendar order keep their order."""
    week_id = torch.as_tensor(week_id, device=device).to(torch.int64)
    key = torch.where((week_id >= 0) & (week_id < n_weeks), week_id,
                      torch.full_like(week_id, n_weeks))
    return torch.argsort(key, stable=True), torch.bincount(key, minlength=n_weeks + 1)


def weekly_partial_sums(ret_d, mask_d, mkt_d, week_id, n_weeks: int, mkt_present=None):
    """Daily rows → the six weekly partial-sum tensors (n_weeks, N);
    ``week_id`` (D,) is each day's week, in any order (ids outside
    ``[0, n_weeks)`` are dropped). Each week's days are added in day order
    over one stable sort of the days by week (``segment_sum``: the same
    bits on every run, where ``index_add_``'s atomics would not be).

    NaN returns follow the reference's polars semantics: aggregate sums
    skip nulls, while ``pl.count()`` counts ALL rows; days the index table
    lacks (``mkt_present`` False) are dropped by the reference's inner join.
    """
    n_weeks = int(n_weeks)
    if mkt_present is None:
        mkt_present = torch.isfinite(mkt_d)
    order, week_lengths = _week_runs(week_id, n_weeks, ret_d.device)
    ret_d, mask_d, mkt_d, mkt_present = (a[order] for a in (ret_d, mask_d, mkt_d, mkt_present))
    present = mask_d & mkt_present[:, None]
    ri_valid = present & torch.isfinite(ret_d)
    rm_valid = present & torch.isfinite(mkt_d)[:, None]
    zero = torch.zeros((), dtype=ret_d.dtype, device=ret_d.device)
    log_ri = torch.where(ri_valid, torch.log1p(ret_d), zero)
    log_rm = torch.where(rm_valid, torch.log1p(mkt_d)[:, None], zero)

    def weekly(a):
        return segment_sum(a, week_lengths)[:n_weeks]

    return (weekly(log_ri), weekly(log_rm),
            weekly(torch.where(ri_valid & rm_valid, log_ri * log_rm, zero)),
            weekly(log_rm * log_rm), weekly(present.to(ret_d.dtype)),
            weekly(rm_valid.to(ret_d.dtype)))


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
    (month, firm); NaN where no valid window start falls in the month.
    ``week_id`` (D,) is each day's week, in any order (``weekly_partial_sums``)."""
    sums = weekly_partial_sums(ret_d, mask_d, mkt_d, week_id, n_weeks,
                               mkt_present=mkt_present)
    return beta_from_weekly_sums(*sums, week_month_id, n_months, window_weeks)
