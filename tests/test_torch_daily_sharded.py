"""The port's firm-sharded daily kernels vs the JAX package's one-device
kernels (``tests/test_daily_sharded.py``).

``parallel.daily_sharded`` on 8 repeated CPU devices against JAX's
``rolling_vol_252_monthly`` (rtol 1e-12) and ``weekly_rolling_beta_monthly``
(rtol 1e-9, atol 1e-12); the outputs come back firm-sharded; and where the
reference inspects the compiled program for collectives, the port's
``COLLECTIVES`` counter does not move — for the dense program and for the
compacted-ingest strips on a mesh (``ops.daily_chunked``), which give the
one-device strips' bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.ops.daily_kernels import (
    rolling_vol_252_monthly as jax_vol,
)
from fm_returnprediction_tpu.ops.daily_kernels import (
    weekly_rolling_beta_monthly as jax_beta,
)
from fm_returnprediction_tpu_torch.ops.daily_chunked import daily_characteristics_compact_chunked
from fm_returnprediction_tpu_torch.parallel import daily_characteristics_sharded, make_mesh
from fm_returnprediction_tpu_torch.parallel import mesh as M

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def daily_inputs():
    rng = np.random.default_rng(17)
    n_days, n_firms, n_months, n_weeks = 400, 52, 19, 60
    ret = 0.02 * rng.standard_normal((n_days, n_firms))
    mask = rng.random((n_days, n_firms)) > 0.15
    ret = np.where(rng.random((n_days, n_firms)) > 0.02, ret, np.nan)
    mkt = 0.01 * rng.standard_normal(n_days)
    mkt[rng.random(n_days) < 0.03] = np.nan
    return dict(ret_d=ret, mask_d=mask, mkt_d=mkt,
                month_id=np.minimum(np.arange(n_days) // 21, n_months - 1),
                week_id=np.minimum(np.arange(n_days) // 7, n_weeks - 1),
                week_month_id=np.minimum(np.arange(n_weeks) * 7 // 21, n_months - 1),
                n_months=n_months, n_weeks=n_weeks)


def _mesh():
    return make_mesh(axis_name="firms", devices=[CPU] * 8)


def test_sharded_daily_matches_single_device(daily_inputs):
    d = daily_inputs
    vol_p, beta_p = daily_characteristics_sharded(mesh=_mesh(), **d)
    n = d["ret_d"].shape[1]
    want_vol = jax_vol(jnp.asarray(d["ret_d"]), jnp.asarray(d["mask_d"]),
                       jnp.asarray(d["month_id"]), d["n_months"])
    want_beta = jax_beta(jnp.asarray(d["ret_d"]), jnp.asarray(d["mask_d"]),
                         jnp.asarray(d["mkt_d"]), jnp.asarray(d["week_id"]), d["n_weeks"],
                         jnp.asarray(d["week_month_id"]), d["n_months"])
    np.testing.assert_allclose(vol_p.numpy()[:, :n], np.asarray(want_vol), rtol=1e-12, atol=0,
                               equal_nan=True)
    np.testing.assert_allclose(beta_p.numpy()[:, :n], np.asarray(want_beta), rtol=1e-9,
                               atol=1e-12, equal_nan=True)


def test_sharded_daily_outputs_stay_firm_sharded(daily_inputs):
    vol, beta = daily_characteristics_sharded(mesh=_mesh(), **daily_inputs)
    assert vol.sharding.spec[1] == "firms" and beta.sharding.spec[1] == "firms"
    assert [s.shape for s in vol.shards] == [(19, 7)] * 8      # 52 firms pad to 56


def _compact(d):
    """The dense inputs in the compacted (CSR) layout of ``panel.daily``."""
    ret, mask = d["ret_d"], d["mask_d"]
    rows = [np.nonzero(mask[:, f])[0] for f in range(ret.shape[1])]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return (np.concatenate([ret[r, f] for f, r in enumerate(rows)]),
            np.concatenate(rows).astype(np.int64), offsets)


def test_sharded_daily_runs_without_collectives(daily_inputs):
    d = daily_inputs
    before = M.collective_counts()
    daily_characteristics_sharded(mesh=_mesh(), **d)
    values, pos, offsets = _compact(d)
    args = (values, pos, offsets, d["mkt_d"], np.isfinite(d["mkt_d"]), d["month_id"],
            d["week_id"], d["week_month_id"], d["ret_d"].shape[0], d["n_weeks"], d["n_months"])
    kw = dict(device=CPU, dtype=torch.float64, window=60, min_periods=20, window_weeks=12,
              height_bucket=64)
    one = daily_characteristics_compact_chunked(*args, firm_chunk=16, **kw)
    sharded = daily_characteristics_compact_chunked(*args, mesh=make_mesh(
        axis_name="firms", devices=[CPU] * 4), **kw)
    assert M.collective_counts() == before
    for a, b in zip(one, sharded):
        np.testing.assert_array_equal(a, b)
