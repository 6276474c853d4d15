"""The port's time-sharded rolling family vs the JAX package's one-device
``ops.rolling`` and ``ops.daily_kernels`` (``tests/test_time_sharded.py``,
``tests/test_time_sharded_property.py``).

The port's shards are repeated CPU devices, where the local cumulative
moments are the moments kernel's plain version. Pins are the reference's:
sum and mean at 1e-12, std at rtol 1e-9 / atol 1e-12 on the fixed cases;
the weekly beta at 1e-9 / 1e-12, with week segments straddling shard seams,
NaN returns and market days, and a ragged length; the property sweep at the
reference's reassociation-aware contract (sum/mean 1e-9, std in the
variance domain 1e-9 and in the std domain rtol 1e-7 / atol 5e-5).
Where the reference reads the halo out of the compiled program, each call
here adds exactly one ``all_gather`` and one ``ppermute`` over ``"time"``.
The count stays an exact int64, and a float32 shard past 2^24 rows raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from fm_returnprediction_tpu.ops.daily_kernels import (
    weekly_rolling_beta_monthly as jax_weekly_beta,
)
from fm_returnprediction_tpu.ops.rolling import rolling_mean as jax_rolling_mean
from fm_returnprediction_tpu.ops.rolling import rolling_std as jax_rolling_std
from fm_returnprediction_tpu.ops.rolling import rolling_sum as jax_rolling_sum
from fm_returnprediction_tpu_torch.parallel import make_mesh
from fm_returnprediction_tpu_torch.parallel import mesh as M
from fm_returnprediction_tpu_torch.parallel import time_sharded as ts

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def _mesh(p=8):
    return make_mesh(axis_name="time", devices=[CPU] * p)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((160, 24))       # 8 shards × 20 rows; w=16 crosses every seam
    x[rng.random((160, 24)) < 0.12] = np.nan
    return x


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), equal_nan=True, **tol)


def test_matches_single_device_sum_mean_and_std(data):
    for mp in (1, 5, 16):
        _close(ts.rolling_sum_time_sharded(data, 16, mp, mesh=_mesh()),
               jax_rolling_sum(jnp.asarray(data), 16, mp), rtol=1e-12, atol=1e-12)
        _close(ts.rolling_std_time_sharded(data, 16, mp, mesh=_mesh()),
               jax_rolling_std(jnp.asarray(data), 16, mp), rtol=1e-9, atol=1e-12)
        _close(ts.rolling_mean_time_sharded(data, 16, mp, mesh=_mesh()),
               jax_rolling_mean(jnp.asarray(data), 16, mp), rtol=1e-12, atol=1e-12)


def test_moments_at_a_seam_and_the_exact_count(data):
    s1, s2, cnt = ts.rolling_moments_time_sharded(data, 16, mesh=_mesh())
    assert cnt.dtype == torch.int64
    finite = np.isfinite(data)
    xz = np.where(finite, data, 0.0)
    row = 20                                 # first row of shard 1: its window spans the seam
    lo = row - 15
    np.testing.assert_array_equal(cnt[row].numpy(), finite[lo:row + 1].sum(axis=0))
    _close(s1[row], xz[lo:row + 1].sum(axis=0), rtol=1e-12, atol=1e-12)
    _close(s2[row], (xz[lo:row + 1] ** 2).sum(axis=0), rtol=1e-12, atol=1e-12)
    tall = torch.zeros((1, 1), dtype=torch.float32).expand(ts.F32_EXACT_COUNT_ROWS + 1, 1)
    with pytest.raises(ValueError, match="2\\^24"):
        ts._local_moments(tall, need_s2=False)


def test_ragged_length_pads_and_trims(data):
    ragged = data[:150]
    got = ts.rolling_std_time_sharded(ragged, 12, 4, mesh=_mesh())
    assert tuple(got.shape) == ragged.shape
    _close(got, jax_rolling_std(jnp.asarray(ragged), 12, 4), rtol=1e-9, atol=1e-12)


def test_window_must_fit_one_shard(data):
    with pytest.raises(ValueError, match="halo"):
        ts.rolling_std_time_sharded(data, 24, 4, mesh=_mesh())


@pytest.mark.parametrize("d_days", [400, 397])
def test_weekly_beta_matches_single_device(d_days):
    rng = np.random.default_rng(77 + d_days)
    n, n_months, n_weeks = 12, 19, 60
    ret = 0.02 * rng.standard_normal((d_days, n))
    ret[rng.random((d_days, n)) < 0.05] = np.nan
    mask = rng.random((d_days, n)) > 0.15
    mkt = 0.01 * rng.standard_normal(d_days)
    mkt[rng.random(d_days) < 0.04] = np.nan
    week_id = np.minimum(np.arange(d_days) // 7, n_weeks - 1)
    week_month_id = np.minimum(np.arange(n_weeks) * 7 // 21, n_months - 1)
    want = jax_weekly_beta(jnp.asarray(ret), jnp.asarray(mask), jnp.asarray(mkt),
                           jnp.asarray(week_id), n_weeks, jnp.asarray(week_month_id), n_months,
                           window_weeks=12)
    before = M.collective_counts()
    got = ts.weekly_rolling_beta_time_sharded(ret, mask, mkt, week_id, n_weeks, week_month_id,
                                              n_months, window_weeks=12, mesh=_mesh())
    assert M.collective_counts()[("psum", "time")] - before.get(("psum", "time"), 0) == 1
    _close(got, want, rtol=1e-9, atol=1e-12)
    # week ids in reverse: each shard sums its days by week, as the
    # reference's segment_sum takes any order
    back = week_id[::-1].copy()
    want_back = jax_weekly_beta(jnp.asarray(ret), jnp.asarray(mask), jnp.asarray(mkt),
                                jnp.asarray(back), n_weeks, jnp.asarray(week_month_id),
                                n_months, window_weeks=12)
    got_back = ts.weekly_rolling_beta_time_sharded(ret, mask, mkt, back, n_weeks,
                                                   week_month_id, n_months, window_weeks=12,
                                                   mesh=_mesh())
    _close(got_back, want_back, rtol=1e-9, atol=1e-12)


def test_each_call_gathers_once_and_permutes_once(data):
    """The halo exchange is real: one prefix ``all_gather`` and one halo
    ``ppermute`` per call, nothing else."""
    before = M.collective_counts()
    ts.rolling_std_time_sharded(data, 16, 4, mesh=_mesh())
    after = M.collective_counts()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert delta == {("all_gather", "time"): 1, ("ppermute", "time"): 1}


@st.composite
def _cases(draw):
    p = draw(st.sampled_from([2, 4, 8]))
    shard_len = draw(st.integers(min_value=2, max_value=12))
    ragged = draw(st.integers(min_value=0, max_value=p - 1))
    t = p * shard_len - ragged
    window = draw(st.integers(min_value=1, max_value=shard_len))
    min_periods = draw(st.integers(min_value=1, max_value=window))
    nan_frac = draw(st.floats(min_value=0.0, max_value=0.6))
    seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, 3))
    x[rng.random((t, 3)) < nan_frac] = np.nan
    return p, x, window, min_periods


@given(_cases())
@settings(max_examples=5, deadline=None)
def test_time_sharded_property_matches_single_device(case):
    p, x, window, min_periods = case
    for single, sharded in ((jax_rolling_sum, ts.rolling_sum_time_sharded),
                            (jax_rolling_mean, ts.rolling_mean_time_sharded)):
        _close(sharded(x, window, min_periods, mesh=_mesh(p)),
               single(jnp.asarray(x), window, min_periods), rtol=1e-9, atol=1e-9)
    got = ts.rolling_std_time_sharded(x, window, min_periods, mesh=_mesh(p)).numpy()
    want = np.asarray(jax_rolling_std(jnp.asarray(x), window, min_periods))
    _close(got * got, want * want, rtol=1e-9, atol=1e-9)
    _close(got, want, rtol=1e-7, atol=5e-5)
