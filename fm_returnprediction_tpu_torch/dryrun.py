"""One-device check of the FM step and a multi-device dry run.

``entry()`` returns the Fama-MacBeth forward step (batched monthly
cross-sectional OLS + Newey-West aggregation → coefficients, t-stats and
the mean R²) and a tiny example panel on the device.

``dryrun_multichip(n)`` builds ``n`` mesh positions over the cards present
(or over the CPU when asked; ``FMRP_VIRTUAL_DEVICES`` makes each device
several positions, and is restored afterwards) and runs ONE step of every
sharding pattern on tiny shapes, each held against its one-device
counterpart:

- firm-sharded Fama-MacBeth by distributed TSQR (gathers over ``firms``);
- the moving-block bootstrap with its replicates sharded (a psum over
  ``boot``);
- the firm-sharded daily vol/beta stage (collective-free; the rolling
  kernel once per shard on the card);
- rolling std with the time axis sharded (the cumulative-moments kernel
  once per time shard, a prefix gather and a halo permute over ``time``)
  and the weekly beta with the day axis sharded (one psum);
- on an even ``n``, the 2-D months × firms hierarchy.

    python -c "from fm_returnprediction_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device

__all__ = ["entry", "dryrun_multichip"]

_VIRTUAL = "FMRP_VIRTUAL_DEVICES"


def _tiny_panel(t=24, n=64, p=14, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p)).astype(dtype)
    beta = rng.standard_normal(p).astype(dtype) * 0.1
    y = (x @ beta + 0.1 * rng.standard_normal((t, n))).astype(dtype)
    mask = rng.random((t, n)) > 0.15
    y = np.where(mask, y, np.nan).astype(dtype)
    return y, x, mask


def entry(device=None):
    """``(fn, args)``: the FM step ``fn(y, x, mask) → (coef, tstat,
    mean_r2)`` and a (24, 64, 14) float32 panel on ``device`` (None means
    the card)."""
    from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth

    def fm_step(y, x, mask):
        cs, summary = fama_macbeth(y, x, mask)
        return summary.coef, summary.tstat, summary.mean_r2

    dev = resolve_device(device)
    return fm_step, tuple(torch.from_numpy(a).to(dev) for a in _tiny_panel())


def _gap(got, want, rtol: float, atol: float, what: str) -> float:
    """The largest ``|got - want|``, after checking it against
    ``atol + rtol·|want|`` with the NaN patterns equal."""
    got = got.detach().cpu().double().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().cpu().double().numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True, err_msg=what)
    both = np.isfinite(got) & np.isfinite(want)
    return float(np.abs(got[both] - want[both]).max(initial=0.0))


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, float]:
    """Run one step of every sharding pattern on ``n_devices`` mesh
    positions of ``device``'s kind (None means the cards) and hold each
    against its one-device counterpart; returns the largest absolute gap of
    each (a failed check raises ``AssertionError``)."""
    dev = resolve_device(device)
    physical = torch.cuda.device_count() if dev.type == "cuda" else 1
    prior = os.environ.get(_VIRTUAL)
    os.environ[_VIRTUAL] = str(max(math.ceil(n_devices / physical), 1))
    try:
        return _dryrun(n_devices, dev)
    finally:
        if prior is None:
            os.environ.pop(_VIRTUAL, None)
        else:
            os.environ[_VIRTUAL] = prior


def _dryrun(n_devices: int, dev: torch.device) -> Dict[str, float]:
    from fm_returnprediction_tpu_torch.ops.daily_kernels import (
        rolling_vol_252_monthly,
        weekly_rolling_beta_monthly,
    )
    from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth
    from fm_returnprediction_tpu_torch.ops.rolling import rolling_std
    from fm_returnprediction_tpu_torch.parallel import (
        block_bootstrap_se,
        daily_characteristics_sharded,
        fama_macbeth_hier,
        fama_macbeth_sharded,
        local_devices,
        make_mesh,
        make_mesh_2d,
        rolling_std_time_sharded,
        weekly_rolling_beta_time_sharded,
    )

    devices = local_devices(dev.type)[:n_devices]
    gaps = {}

    # firm-sharded TSQR Fama-MacBeth against the one-device QR route
    y, x, mask = (torch.from_numpy(a).to(dev) for a in _tiny_panel(t=20, n=8 * n_devices,
                                                                 p=5, seed=1))
    firm_mesh = make_mesh(n_devices=n_devices, axis_name="firms", devices=devices)
    cs, summary = fama_macbeth_sharded(y, x, mask, mesh=firm_mesh)
    cs_1, summary_1 = fama_macbeth(y, x, mask)
    assert bool(torch.isfinite(summary.coef).all()), "non-finite FM coefs"
    gaps["fm_sharded_slopes"] = _gap(cs.slopes, cs_1.slopes, 0.0, 1e-4, "sharded FM slopes")

    # the bootstrap with its replicates sharded against the one-device draw
    boot_mesh = make_mesh(n_devices=n_devices, axis_name="boot", devices=devices)
    slopes = cs.slopes.to(dev)
    slope_valid = cs.month_valid.to(dev)[:, None] & torch.isfinite(slopes)
    res = block_bootstrap_se(slopes, slope_valid, seed=0, n_replicates=16 * n_devices,
                             mesh=boot_mesh)
    res_1 = block_bootstrap_se(slopes, slope_valid, seed=0, n_replicates=16 * n_devices)
    assert bool(torch.isfinite(res.se).all()), "non-finite bootstrap SEs"
    gaps["bootstrap_se"] = _gap(res.se, res_1.se, 1e-5, 1e-7, "sharded bootstrap SEs")

    # the daily stage, firm-sharded, against the one-device daily steps
    rng = np.random.default_rng(2)
    d_days, n_firms, n_months_d, n_weeks = 130, 8 * n_devices, 6, 27
    ret_d = (0.02 * rng.standard_normal((d_days, n_firms))).astype(np.float32)
    mask_d = rng.random((d_days, n_firms)) > 0.1
    mkt_d = (0.01 * rng.standard_normal(d_days)).astype(np.float32)
    month_id = np.minimum(np.arange(d_days) // 21, n_months_d - 1)
    week_id = np.minimum(np.arange(d_days) // 5, n_weeks - 1)
    week_month_id = np.minimum(np.arange(n_weeks) * 5 // 21, n_months_d - 1)
    vol_s, beta_s = daily_characteristics_sharded(
        ret_d, mask_d, mkt_d, month_id, week_id, week_month_id,
        n_months=n_months_d, n_weeks=n_weeks, mesh=firm_mesh,
        window=60, min_periods=20, window_weeks=12,
    )
    ret_t, mask_t, mkt_t = (torch.from_numpy(a).to(dev) for a in (ret_d, mask_d, mkt_d))
    vol_1 = rolling_vol_252_monthly(ret_t, mask_t, torch.as_tensor(month_id, device=dev),
                                    n_months_d, window=60, min_periods=20)
    beta_1 = weekly_rolling_beta_monthly(ret_t, mask_t, mkt_t,
                                         torch.as_tensor(week_id, device=dev), n_weeks,
                                         torch.as_tensor(week_month_id, device=dev),
                                         n_months_d, window_weeks=12)
    gaps["daily_vol"] = _gap(vol_s.to_global()[:, :n_firms], vol_1, 1e-5, 1e-7,
                             "firm-sharded daily vol")
    gaps["daily_beta"] = _gap(beta_s.to_global()[:, :n_firms], beta_1, 1e-4, 1e-6,
                              "firm-sharded daily beta")

    # rolling std with the time axis sharded against the one-device roll
    seq = (0.02 * rng.standard_normal((16 * n_devices, 8))).astype(np.float32)
    seq[rng.random(seq.shape) < 0.1] = np.nan
    seq_t = torch.from_numpy(seq).to(dev)
    time_mesh = make_mesh(n_devices=n_devices, axis_name="time", devices=devices)
    gaps["time_sharded_std"] = _gap(rolling_std_time_sharded(seq_t, 12, 4, mesh=time_mesh),
                                    rolling_std(seq_t, 12, 4), 1e-5, 1e-7,
                                    "time-sharded rolling std")
    beta_ts = weekly_rolling_beta_time_sharded(ret_t, mask_t, mkt_t, week_id, n_weeks,
                                               week_month_id, n_months_d, window_weeks=12,
                                               mesh=time_mesh)
    gaps["time_sharded_beta"] = _gap(beta_ts, beta_1, 1e-4, 1e-6, "time-sharded weekly beta")

    if n_devices >= 2 and n_devices % 2 == 0:
        # the months × firms hierarchy on a 2-row carve-up of the positions
        mesh2d = make_mesh_2d(month_shards=2, devices=devices)
        cs_h, fm_h = fama_macbeth_hier(y, x, mask, mesh=mesh2d)
        assert bool(torch.isfinite(fm_h.coef).all()), "non-finite hierarchical FM coefs"
        gaps["hier_slopes"] = _gap(cs_h.slopes, cs.slopes, 0.0, 1e-4,
                                   "hierarchical vs firm-sharded slopes")
    return gaps
