"""The port's panel operations vs the JAX package's: compaction, quantiles,
winsorization, subset masks, the monthly characteristics and the daily
strips.

Same float64 inputs (numpy, seeded) on both sides. Index plans and masks
must be exactly equal; characteristic values agree at rtol 1e-10 (and the
daily vol and beta at rtol 1e-10) with identical NaN patterns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.ops import compaction as jax_compaction
from fm_returnprediction_tpu.ops import quantiles as jax_quantiles
from fm_returnprediction_tpu.ops.daily_chunked import (
    daily_characteristics_compact_chunked as jax_daily_chunked,
)
from fm_returnprediction_tpu.ops.daily_compact import (
    daily_compact_strip as jax_strip,
    daily_compact_strip_contiguous as jax_strip_contiguous,
)
from fm_returnprediction_tpu.panel import characteristics as jax_chars
from fm_returnprediction_tpu.panel import subsets as jax_subsets
from fm_returnprediction_tpu.panel.dense import DensePanel as JaxPanel
from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs
from fm_returnprediction_tpu_torch.ops import compaction, quantiles
from fm_returnprediction_tpu_torch.ops.daily_chunked import (
    daily_characteristics_compact_chunked,
)
from fm_returnprediction_tpu_torch.ops.daily_compact import (
    daily_compact_strip,
    daily_compact_strip_contiguous,
)
from fm_returnprediction_tpu_torch.panel import characteristics, subsets

pytestmark = pytest.mark.torch_port

T = torch.from_numpy


def _close(got, want, what, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True,
                               err_msg=what)


@pytest.fixture(scope="module")
def monthly():
    base, daily = make_smoke_inputs(n_firms=90, n_months=80, seed=11,
                                    dtype=np.float64)
    rng = np.random.default_rng(11)
    mask = base.mask.copy()
    mask[rng.random(mask.shape) < 0.05] = False      # listing gaps
    values = np.where(mask[:, :, None], base.values, np.nan)
    values[rng.random(values.shape) < 0.03] = np.nan  # missing data
    return values, mask, base, daily


# -- compaction -----------------------------------------------------------


def test_compaction_plan_is_identical(monthly):
    _, mask, _, _ = monthly
    got = compaction.make_compaction(T(mask))
    want = jax_compaction.make_compaction(jnp.asarray(mask))
    for name in ("order", "inv_order", "count", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("k", [0, 1, 12, 200])
def test_compact_lag_scatter_roundtrip(monthly, k):
    values, mask, _, _ = monthly
    x = values[:, :, 0]
    plan_t = compaction.make_compaction(T(mask))
    plan_j = jax_compaction.make_compaction(jnp.asarray(mask))
    got = compaction.scatter_back(compaction.lag(compaction.compact(T(x), plan_t), k), plan_t)
    want = jax_compaction.scatter_back(
        jax_compaction.lag(jax_compaction.compact(jnp.asarray(x), plan_j), k), plan_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- quantiles and winsorization -------------------------------------------


@pytest.mark.parametrize("q", [0.2, [0.2, 0.5], [0.0, 0.01, 0.99, 1.0]])
def test_masked_quantile_matches(monthly, q):
    values, mask, _, _ = monthly
    x = values[:, :, 3]
    valid = mask.copy()
    valid[5] = False                        # a month with no valid entry
    got = quantiles.masked_quantile(T(x), T(valid), q)
    want = jax_quantiles.masked_quantile(jnp.asarray(x), jnp.asarray(valid),
                                         jnp.asarray(q))
    _close(got.numpy(), want, f"q={q}", rtol=1e-13)


@pytest.mark.parametrize("n_firms", [90, 1000])   # full-sort and top-k routes
def test_winsorize_matches(n_firms):
    rng = np.random.default_rng(n_firms)
    x = rng.standard_normal((20, n_firms)) * np.exp(rng.standard_normal((20, n_firms)))
    valid = rng.random((20, n_firms)) > 0.2
    valid[3, 4:] = False                    # a month below min_obs
    x[~valid & (rng.random(x.shape) < 0.5)] = np.nan
    got = quantiles.winsorize_cs(T(x), T(valid))
    want = jax_quantiles.winsorize_cs(jnp.asarray(x), jnp.asarray(valid))
    _close(got.numpy(), want, "winsorize_cs", rtol=1e-13)
    stack = np.stack([x, -x, 2 * x])
    got_b = quantiles.winsorize_cs_batched(T(stack), T(valid))
    want_b = jax_quantiles.winsorize_cs_batched(jnp.asarray(stack), jnp.asarray(valid))
    _close(got_b.numpy(), want_b, "winsorize_cs_batched", rtol=1e-13)


def test_subset_masks_are_identical(monthly):
    values, mask, base, _ = monthly
    values = values.copy()
    k = base.var_names.index("is_nyse")
    values[7, :, k] = np.where(mask[7], 0.0, np.nan)   # a month with no NYSE firm
    kw = dict(mask=mask, months=base.months, ids=base.ids,
              var_names=list(base.var_names))
    got = subsets.compute_subset_masks(
        type(base)(values=T(values), **kw))
    want = jax_subsets.compute_subset_masks(JaxPanel(values=values, **kw))
    for name in subsets.SUBSET_ORDER:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)


# -- the monthly characteristics -------------------------------------------


@pytest.mark.parametrize("turnover", [False, True])
def test_monthly_characteristics_match(monthly, turnover):
    values, mask, base, _ = monthly
    var_index = {n: base.var_names.index(n) for n in characteristics.BASE_COLUMNS}
    if turnover:   # the opt-in 16th characteristic reads a volume column
        k = var_index["shrout"]
        values = np.concatenate([values, values[:, :, k:k + 1] * 80.0], axis=-1)
        var_index["vol"] = values.shape[-1] - 1
    got = characteristics.compute_monthly_characteristics(T(values), T(mask), var_index)
    want = jax_chars.compute_monthly_characteristics(
        jnp.asarray(values), jnp.asarray(mask), tuple(var_index.items()))
    assert sorted(got) == sorted(want)
    for name in got:
        _close(got[name].numpy(), want[name], name)


# -- the daily strips ------------------------------------------------------


def _with_gaps(daily, every=3, frac=0.1, seed=5):
    """Drop ``frac`` of the rows of every ``every``-th firm, so those firms'
    rows are no longer day-contiguous (the scatter route)."""
    rng = np.random.default_rng(seed)
    counts = daily.counts
    firm = np.repeat(np.arange(len(counts)), counts)
    keep = ~((firm % every == 0) & (rng.random(len(firm)) < frac))
    offsets = np.zeros_like(daily.offsets)
    np.cumsum(np.bincount(firm[keep], minlength=len(counts)), out=offsets[1:])
    return daily.row_values[keep], daily.row_pos[keep], offsets


def _strip(daily, firms):
    counts = daily.counts[firms]
    h = int(counts.max())
    rect = np.full((h, len(firms)), np.nan)
    pos = np.full((h, len(firms)), daily.n_days, dtype=np.int64)
    for k, f in enumerate(firms):
        a, b = daily.offsets[f], daily.offsets[f + 1]
        rect[: b - a, k] = daily.row_values[a:b]
        pos[: b - a, k] = daily.row_pos[a:b]
    starts = np.asarray([daily.row_pos[daily.offsets[f]] for f in firms], np.int64)
    return rect, pos, starts, counts.astype(np.int64)


def _calendar(daily):
    return (daily.mkt, daily.mkt_present, daily.day_month_id, daily.week_id,
            daily.week_month_id)


@pytest.mark.parametrize("contiguous", [True, False])
def test_daily_strip_matches(monthly, contiguous):
    _, _, _, daily = monthly
    rect, pos, starts, counts = _strip(daily, np.arange(0, 40))
    static = dict(n_days=daily.n_days, n_months=daily.n_months)
    cal = _calendar(daily)
    if contiguous:
        got = daily_compact_strip_contiguous(
            T(rect), T(starts), T(counts), *(T(np.asarray(a)) for a in cal),
            n_weeks=daily.n_weeks, **static)
        want = jax_strip_contiguous(
            jnp.asarray(rect), jnp.asarray(starts), jnp.asarray(counts),
            *(jnp.asarray(a) for a in cal), n_weeks=daily.n_weeks, **static)
    else:
        got = daily_compact_strip(T(rect), T(pos), *(T(np.asarray(a)) for a in cal),
                                  n_weeks=daily.n_weeks, **static)
        want = jax_strip(jnp.asarray(rect), jnp.asarray(pos),
                         *(jnp.asarray(a) for a in cal), n_weeks=daily.n_weeks,
                         **static)
    _close(got[0].numpy(), want[0], "vol")
    _close(got[1].numpy(), want[1], "beta")


@pytest.mark.parametrize("gaps", [False, True])
def test_daily_chunked_matches(monthly, gaps):
    _, _, _, daily = monthly
    rows, pos, offsets = ((daily.row_values, daily.row_pos, daily.offsets)
                          if not gaps else _with_gaps(daily))
    args = (rows, pos, offsets, daily.mkt, daily.mkt_present, daily.day_month_id,
            daily.week_id, daily.week_month_id, daily.n_days, daily.n_weeks,
            daily.n_months)
    got = daily_characteristics_compact_chunked(
        *args, device=torch.device("cpu"), dtype=torch.float64, firm_chunk=32)
    want = jax_daily_chunked(*args, firm_chunk=32, use_pallas=False)
    _close(got[0], want[0], "vol")
    _close(got[1], want[1], "beta")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_weekly_segment_sum_adds_rows_in_order(dtype):
    """The beta stage's weekly sums add each week's days in day order, bit
    for bit a sequential scatter-add (``np.add.at``); a week with no day
    sums to 0."""
    from fm_returnprediction_tpu_torch.ops.daily_kernels import segment_sum

    rng = np.random.default_rng(11)
    seg = np.sort(rng.integers(0, 60, 400))
    seg[seg == 7] = 8                                   # an empty week
    a = rng.standard_normal((400, 9)).astype(dtype)
    want = np.zeros((60, 9), dtype)
    np.add.at(want, seg, a)
    got = segment_sum(T(a), T(np.bincount(seg, minlength=60))).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[7].any()


def test_compact_daily_refuses_decreasing_week_ids(monthly):
    """A calendar whose week ids go back (two days' weeks swapped) is
    taken as the reference takes it: the weekly sums regroup the days by
    one stable sort of their weeks, so the compact route on it matches the
    JAX package's at 1e-10."""
    import dataclasses
    import types

    from fm_returnprediction_tpu_torch.convert import prepared_from_numpy

    _, _, base, daily = monthly
    week_id = np.asarray(daily.week_id).copy()
    week_id[[3, 10]] = week_id[[10, 3]]
    assert week_id[10] < week_id[9]
    produced = types.SimpleNamespace(**{**dataclasses.asdict(daily), "week_id": week_id})
    _, swapped = prepared_from_numpy(base, produced)
    np.testing.assert_array_equal(swapped.week_id, week_id)
    args = (daily.row_values, daily.row_pos, daily.offsets, daily.mkt, daily.mkt_present,
            daily.day_month_id, week_id, daily.week_month_id, daily.n_days, daily.n_weeks,
            daily.n_months)
    got = daily_characteristics_compact_chunked(*args, firm_chunk=32, device="cpu",
                                                dtype=torch.float64)
    want = jax_daily_chunked(*args, firm_chunk=32, use_pallas=False)
    _close(got[0], want[0], "vol")
    _close(got[1], want[1], "beta")
