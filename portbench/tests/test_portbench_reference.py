"""The plain reference and the frozen counts, on the CPU.

The reference's Fama-MacBeth regressions agree with a direct float64
least-squares loop; its whole Lewellen replication agrees with the program
run in float64 on a small panel (the two were written apart, so agreement
checks both); the roofline counts match a case counted by hand.
"""

import numpy as np
import pytest
import torch

from portbench.compare import rel_gap, scaled_gap
from portbench.inputs.lewellen import make_lewellen_inputs
from portbench.reference.fm import fm_summary, monthly_cs
from portbench.roofline import bound_s, k1_rolling, k2_bytes, k2_pair


def _lstsq_fm(y, x, mask, lags=4, min_months=10):
    """Fama-MacBeth by a float64 least-squares solve a month, in numpy."""
    slopes, r2s, ns = [], [], []
    for t in range(y.shape[0]):
        ok = mask[t] & np.isfinite(y[t]) & np.isfinite(x[t]).all(axis=1)
        if ok.sum() < x.shape[2] + 1:
            continue
        design = np.c_[np.ones(ok.sum()), x[t][ok]]
        beta, *_ = np.linalg.lstsq(design, y[t][ok], rcond=None)
        resid = y[t][ok] - design @ beta
        sst = ((y[t][ok] - y[t][ok].mean()) ** 2).sum()
        slopes.append(beta[1:])
        r2s.append(1.0 - (resid ** 2).sum() / sst)
        ns.append(ok.sum())
    s = np.array(slopes)
    m = s.shape[0]
    u = s - s.mean(axis=0)
    acc = (u * u).sum(axis=0)
    for k in range(1, lags + 1):
        acc = acc + 2.0 * max(1.0 - k / m, 0.0) * (u[k:] * u[:-k]).sum(axis=0)
    se = np.sqrt(acc / m ** 2)
    assert m >= min_months
    return s.mean(axis=0), se, float(np.mean(r2s)), float(np.mean(ns))


def test_reference_fm_matches_a_direct_lstsq_loop():
    rng = np.random.default_rng(4)
    t, n, p = 30, 80, 4
    x = rng.standard_normal((t, n, p))
    y = x @ np.array([0.5, -0.2, 0.1, 0.0]) + rng.standard_normal((t, n))
    mask = rng.random((t, n)) < 0.9
    x[rng.random((t, n, p)) < 0.02] = np.nan
    y[3, :78] = np.nan  # a month too thin to run
    coef, se, r2, mean_n = _lstsq_fm(y, x, mask)
    fm = fm_summary(monthly_cs(torch.tensor(y), torch.tensor(x), torch.tensor(mask)))
    assert rel_gap(fm.coef.numpy(), coef) < 1e-10
    assert rel_gap(fm.nw_se.numpy(), se) < 1e-10
    assert abs(fm.mean_r2 - r2) < 1e-12 and abs(fm.mean_n - mean_n) < 1e-12
    assert fm.n_months == t - 1 and fm.suspect_months == 0


def test_roofline_counts_a_hand_made_case():
    # K2: 3 (month, firm) rows of nonzero weight of 6 (two lie outside the
    # universe, one misses a column); P = 2 gives a 4-square product of
    # [1, x1, x2, y], 10 entries in its upper triangle
    valid = np.array([[1, 0, 1], [1, 1, 0]], bool)
    finite = np.array([[1, 1, 1], [1, 1, 1]], bool)
    finite[1, 1] = False
    rows = int((valid & finite).sum())
    assert rows == 3
    assert k2_pair(rows, 2) == 2 * 3 * 10
    assert k2_bytes([24, 8], [(3, 2)], t=2) == 24 + 8 + 2 * 16 * 4
    assert k1_rolling(10) == (80.0, 120.0)
    sec, by = bound_s(3.35e12, 1.0)
    assert by == "bytes" and sec == pytest.approx(1.0)
    sec, by = bound_s(1.0, 67e12)
    assert by == "operations" and sec == pytest.approx(1.0)


def test_reference_replication_matches_the_program_in_float64():
    """The reference and the program, both in float64 on a small panel,
    agree on every output the main path's cell compares."""
    from portbench.reference.lewellen import replicate
    from portbench.traffic.main_path import Traffic, compare_main, program_inputs
    from fm_returnprediction_tpu_torch.pipeline import run_pipeline

    inp = make_lewellen_inputs(21, n_firms=400, n_months=150)
    base, daily = program_inputs(inp)
    res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu",
                       dtype=torch.float64, guard=True, compile_pdf=False)
    drv = Traffic({"params": {"warm_calls": 0}}, {"sizes": {}, "dtype": "float64"}, 21, "cpu")
    drv.inp = inp
    got = drv.outputs(res)
    gaps = compare_main(got, replicate(inp, dtype=torch.float64, device="cpu",
                                       breakpoint_dtype=torch.float64))
    assert gaps["char_nan"] == 0 and gaps["universe_diff"] == 0 and gaps["t1_n"] == 0
    assert gaps["dec_months"] == 0
    assert gaps["char_gap"] < 1e-10 and gaps["t1_gap"] < 1e-10
    assert gaps["fig_gap"] < 1e-9 and gaps["serving_gap"] < 1e-9
    assert gaps["dec_ret"] < 1e-9 and gaps["dec_t"] < 1e-9
    # the thinnest months of a 400-firm panel are ill-conditioned, where the
    # program's Gram route and the reference's solve part at ~1e-6 of a
    # standard error in float64
    assert gaps["t2_coef"] < 1e-4 and gaps["t2_se"] < 1e-4 and gaps["t2_r2"] < 1e-10
    assert scaled_gap([gaps["t2_n"]], [0.0], 1.0) < 1e-12
