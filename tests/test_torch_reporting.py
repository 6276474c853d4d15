"""Slice 2's modules vs their JAX counterparts on the same panel.

The JAX package builds an enriched float64 panel from its synthetic
universe (250 firms × 120 months, sized so that every universe has usable
decile months at the default ``min_obs=50``); the port's modules get the
same values as CPU tensors. Tolerances, per assertion: the compaction
roll rtol 1e-12, sufficient stats rtol 1e-12, Table 1 Avg/Std rtol 1e-10
with N exact (std rtol 1e-6 between the one-pass and two-pass routes, as
the JAX package pins it), forecasts, deciles, figure frames and serving
state rtol 1e-8 with counts and flags exact — the cross-sections come from
eigh/QR solves on each side, summed in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu.models import forecast as jax_forecast
from fm_returnprediction_tpu.ops.compaction import (
    rolling_over_valid_rows as jax_rolling_over_valid_rows,
)
from fm_returnprediction_tpu.ops.ols import sufficient_stats as jax_sufficient_stats
from fm_returnprediction_tpu.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu.pipeline import build_panel, build_panel_prepared
from fm_returnprediction_tpu.reporting import figure1 as jax_figure1
from fm_returnprediction_tpu.reporting.deciles import build_decile_table as jax_decile_table
from fm_returnprediction_tpu.reporting.table1 import build_table_1 as jax_table_1
from fm_returnprediction_tpu.reporting.table1 import table1_stats_multi as jax_table1_multi
from fm_returnprediction_tpu.serving.state import ServingState as JaxServingState
from fm_returnprediction_tpu.serving.state import (
    build_serving_state_from_panel as jax_serving_state,
)
from fm_returnprediction_tpu_torch.models import forecast
from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS
from fm_returnprediction_tpu_torch.ops.compaction import rolling_over_valid_rows
from fm_returnprediction_tpu_torch.ops.ols import sufficient_stats
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.reporting import figure1
from fm_returnprediction_tpu_torch.reporting.deciles import build_decile_table
from fm_returnprediction_tpu_torch.reporting.table1 import (
    build_table_1,
    table1_stats,
    table1_stats_multi,
)
from fm_returnprediction_tpu_torch.serving.state import (
    ServingState,
    build_serving_state_from_panel,
)

pytestmark = pytest.mark.torch_port

XVARS = list(FIGURE1_VARS)
SERVING_FLOATS = ("coef", "slopes_bar", "intercept_bar", "gram", "moment", "ysum", "yy")
SERVING_EXACT = ("n_obs", "month_valid", "x_lo", "x_hi")


@pytest.fixture(scope="module")
def jax_side():
    capture = {}
    data = generate_synthetic_wrds(SyntheticConfig(n_firms=250, n_months=120))
    build_panel(data, dtype=np.float64, capture=capture)
    panel, factors = build_panel_prepared(capture["dense_base"], capture["compact_daily"],
                                          dtype=np.float64)
    masks = compute_subset_masks(panel)
    sweep = jax_figure1.subset_sweep(panel, masks, list(masks))
    return dict(panel=panel, factors=factors, masks=masks, sweep=sweep)


@pytest.fixture(scope="module")
def port_side(jax_side):
    jp = jax_side["panel"]
    panel = DensePanel(values=torch.from_numpy(np.array(jp.values)),
                       mask=np.asarray(jp.mask), months=np.asarray(jp.months),
                       ids=np.asarray(jp.ids), var_names=list(jp.var_names))
    masks = {k: torch.from_numpy(np.array(m)) for k, m in jax_side["masks"].items()}
    sweep = figure1.subset_sweep(panel, masks, list(masks))
    return dict(panel=panel, masks=masks, sweep=sweep)


def _close(got, want, rtol, what=""):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, dtype=float)
    want = np.asarray(want, dtype=float)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True, err_msg=what)


def _exact(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def test_every_universe_has_usable_decile_months(jax_side, port_side):
    for name, entry in jax_side["sweep"].items():
        assert int(entry.deciles.n_months) >= 1, name
        assert int(port_side["sweep"][name].deciles.n_months) >= 1, name


# -- ops ------------------------------------------------------------------


def _series(seed=3, t=150, k=6):
    """Series away from zero: both sides difference cumulative sums (summed
    in other orders), so a window mean near zero would carry an absolute
    error of eps·|cumulative sum| that no relative tolerance describes."""
    rng = np.random.default_rng(seed)
    values = 1.0 + 0.3 * rng.standard_normal((t, k))
    values[rng.random(values.shape) < 0.05] = np.nan
    valid = rng.random(t) < 0.7
    return values, valid


@pytest.mark.parametrize("row_lag,fill_invalid", [(0, False), (1, False), (1, True), (3, True)])
def test_rolling_over_valid_rows_matches_jax(row_lag, fill_invalid):
    values, valid = _series()
    for window, mp in ((24, 12), (120, 60), (5, 1)):
        got = rolling_over_valid_rows(torch.from_numpy(values), torch.from_numpy(valid),
                                      window, mp, row_lag=row_lag, fill_invalid=fill_invalid)
        want = jax_rolling_over_valid_rows(jnp.asarray(values), jnp.asarray(valid), window,
                                           mp, row_lag=row_lag, fill_invalid=fill_invalid)
        _close(got, want, 1e-12, f"w={window} mp={mp}")


def test_rolling_over_valid_rows_batched_equals_each_series():
    rows = [_series(seed) for seed in (4, 5, 6)]
    values = torch.from_numpy(np.stack([v for v, _ in rows]))
    valid = torch.from_numpy(np.stack([m for _, m in rows]))
    got = rolling_over_valid_rows(values, valid, 24, 12, row_lag=1)
    for i, (v, m) in enumerate(rows):
        alone = rolling_over_valid_rows(values[i], valid[i], 24, 12, row_lag=1)
        assert torch.equal(torch.isnan(got[i]), torch.isnan(alone))
        assert torch.equal(torch.nan_to_num(got[i]), torch.nan_to_num(alone))
        want = jax_rolling_over_valid_rows(jnp.asarray(v), jnp.asarray(m), 24, 12, row_lag=1)
        _close(got[i], want, 1e-12, f"series {i}")


def test_fill_invalid_without_row_lag_raises():
    values, valid = _series()
    with pytest.raises(ValueError, match="row_lag"):
        rolling_over_valid_rows(torch.from_numpy(values), torch.from_numpy(valid), 24, 12,
                                fill_invalid=True)
    with pytest.raises(ValueError, match="row_lag"):
        jax_rolling_over_valid_rows(jnp.asarray(values), jnp.asarray(valid), 24, 12,
                                    fill_invalid=True)


def test_sufficient_stats_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((7, 40, 4))
    y = rng.standard_normal((7, 40))
    valid = rng.random((7, 40)) < 0.8
    got = sufficient_stats(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(valid))
    want = jax_sufficient_stats(jnp.asarray(y), jnp.asarray(x), jnp.asarray(valid))
    for name in ("gram", "moment", "n", "ysum", "yy"):
        _close(getattr(got, name), getattr(want, name), 1e-12, name)


# -- Table 1 --------------------------------------------------------------


def _table1_inputs(side, factors):
    panel = side["panel"]
    values = panel.values[:, :, [panel.var_index(c) for c in factors.values()]]
    return values, side["masks"]


def test_table1_stats_multi_matches_jax(jax_side, port_side):
    values, masks = _table1_inputs(port_side, jax_side["factors"])
    stacked = torch.stack(list(masks.values()))
    avg, std, n = table1_stats_multi(values, stacked)
    w_avg, w_std, w_n = jax_table1_multi(jnp.asarray(values.numpy()),
                                         jnp.asarray(stacked.numpy()))
    _close(avg, w_avg, 1e-10, "avg")
    _close(std, w_std, 1e-10, "std")
    _exact(n, w_n, "n")


def test_table1_one_pass_matches_two_pass(jax_side, port_side):
    values, masks = _table1_inputs(port_side, jax_side["factors"])
    avg, std, n = table1_stats_multi(values, torch.stack(list(masks.values())))
    for si, mask in enumerate(masks.values()):
        a2, s2, n2 = table1_stats(values, mask)
        _close(avg[si], a2.numpy(), 1e-10, "avg")
        _close(std[si], s2.numpy(), 1e-6, "std")
        _exact(n[si], n2.numpy(), "n")


def test_build_table_1_matches_jax(jax_side, port_side):
    got = build_table_1(port_side["panel"], port_side["masks"], jax_side["factors"])
    want = jax_table_1(jax_side["panel"], jax_side["masks"], jax_side["factors"])
    assert got.shape == (15, 9)
    assert list(got.index) == list(want.index) and got.index.name == "Column"
    assert list(got.columns) == list(want.columns)
    for col in got.columns:
        if col[1] == "N":
            _exact(got[col].to_numpy(), want[col].to_numpy(), str(col))
        else:
            _close(got[col].to_numpy(), want[col].to_numpy(), 1e-10, str(col))


# -- forecast and deciles -------------------------------------------------


def test_rolling_er_forecast_and_deciles_match_jax(jax_side, port_side):
    """The self-contained route (QR cross-sections on each side)."""
    jp, pp = jax_side["panel"], port_side["panel"]
    mask = "All stocks"
    want = jax_forecast.rolling_er_forecast(jnp.asarray(jp.var("retx")),
                                            jnp.asarray(jp.select(XVARS)),
                                            jnp.asarray(jax_side["masks"][mask]))
    got = forecast.rolling_er_forecast(pp.var("retx"), pp.select(XVARS),
                                       port_side["masks"][mask])
    for name in ("er", "slopes_bar", "intercept_bar"):
        _close(getattr(got, name), getattr(want, name), 1e-8, name)
    _exact(got.er_valid, want.er_valid, "er_valid")

    want_dec = jax_forecast.decile_sorts(want.er, want.er_valid, jnp.asarray(jp.var("retx")))
    got_dec = forecast.decile_sorts(got.er, got.er_valid, pp.var("retx"))
    assert int(got_dec.n_months) >= 1
    for name in ("decile_returns", "mean_returns", "spread", "spread_tstat"):
        _close(getattr(got_dec, name), getattr(want_dec, name), 1e-8, name)
    for name in ("decile_counts", "month_valid", "n_months"):
        _exact(getattr(got_dec, name), getattr(want_dec, name), name)


def test_subset_sweep_matches_jax(jax_side, port_side):
    assert list(port_side["sweep"]) == list(jax_side["sweep"])
    for name, want in jax_side["sweep"].items():
        got = port_side["sweep"][name]
        for leaf in ("slopes", "intercept", "r2", "n_obs"):
            _close(getattr(got.cs, leaf), getattr(want.cs, leaf), 1e-8, f"{name} {leaf}")
        _exact(got.cs.month_valid, want.cs.month_valid, f"{name} month_valid")
        _close(got.rolled, want.rolled, 1e-8, f"{name} rolled")
        for leaf in ("decile_returns", "mean_returns", "spread", "spread_tstat"):
            _close(getattr(got.deciles, leaf), getattr(want.deciles, leaf), 1e-8,
                   f"{name} {leaf}")
        for leaf in ("decile_counts", "month_valid", "n_months"):
            _exact(getattr(got.deciles, leaf), getattr(want.deciles, leaf), f"{name} {leaf}")
        assert got.decile_params == want.decile_params


@pytest.mark.parametrize("subset", ["All stocks", "Large stocks"])
def test_rolling_slopes_frames_match_jax(jax_side, port_side, subset):
    entry = port_side["sweep"][subset]
    got = figure1.rolling_slopes(port_side["panel"], port_side["masks"][subset],
                                 cs=entry.cs, rolled=entry.rolled)
    jentry = jax_side["sweep"][subset]
    want = jax_figure1.rolling_slopes(jax_side["panel"], jax_side["masks"][subset],
                                      cs=jentry.cs, rolled=jentry.rolled)
    assert got.index.equals(want.index) and got.index.name == "mthcaldt"
    assert list(got.columns) == list(want.columns) == XVARS
    _close(got.to_numpy(), want.to_numpy(), 1e-8, subset)
    # the self-contained route (QR cross-section, rolled here) agrees too
    alone = figure1.rolling_slopes(port_side["panel"], port_side["masks"][subset])
    assert alone.index.equals(want.index)
    _close(alone.to_numpy(), want.to_numpy(), 1e-8, f"{subset} self-contained")


def test_decile_table_matches_jax(jax_side, port_side):
    got = build_decile_table(port_side["panel"], port_side["masks"],
                             cs_cache=port_side["sweep"])
    want = jax_decile_table(jax_side["panel"], jax_side["masks"], cs_cache=jax_side["sweep"])
    assert got.shape == (13, 3) and got.index.name == "Portfolio"
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    _exact(got.loc["Months"].to_numpy(), want.loc["Months"].to_numpy(), "Months")
    _close(got.drop(index="Months").to_numpy(), want.drop(index="Months").to_numpy(),
           1e-8, "deciles")
    # without the sweep the builder computes each leg itself
    alone = build_decile_table(port_side["panel"], port_side["masks"])
    _exact(alone.loc["Months"].to_numpy(), want.loc["Months"].to_numpy(), "Months")
    _close(alone.drop(index="Months").to_numpy(), want.drop(index="Months").to_numpy(),
           1e-8, "deciles, self-contained")


def test_decile_table_refuses_other_parameters_than_the_sweeps(port_side):
    with pytest.raises(ValueError, match="decile parameters"):
        build_decile_table(port_side["panel"], port_side["masks"], min_obs=40,
                           cs_cache=port_side["sweep"])


# -- serving state --------------------------------------------------------


@pytest.fixture(scope="module")
def serving_pair(jax_side, port_side):
    want = jax_serving_state(jax_side["panel"], jax_side["masks"]["All stocks"],
                             cs=jax_side["sweep"]["All stocks"].cs)
    got = build_serving_state_from_panel(port_side["panel"], port_side["masks"]["All stocks"],
                                         cs=port_side["sweep"]["All stocks"].cs)
    return got, want


def _assert_states_match(got, want):
    _exact(got.months, want.months, "months")
    assert got.xvars == want.xvars
    assert (got.window, got.min_periods, got.solver) == (want.window, want.min_periods,
                                                          want.solver)
    for name in SERVING_FLOATS:
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
        _close(getattr(got, name), getattr(want, name), 1e-8, name)
    for name in SERVING_EXACT:
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
        _exact(getattr(got, name), getattr(want, name), name)


def test_serving_state_matches_jax(serving_pair):
    got, want = serving_pair
    _assert_states_match(got, want)
    assert got.have_coef().sum() > 0
    _exact(got.have_coef(), want.have_coef(), "have_coef")


def test_serving_state_cross_loads(serving_pair, tmp_path):
    got, want = serving_pair
    port_file = got.save(tmp_path / "port_state")
    _assert_states_match(JaxServingState.load(port_file), want)
    jax_file = want.save(tmp_path / "jax_state.npz")
    _assert_states_match(ServingState.load(jax_file), want)


def test_create_figure_1_draws_both_panels(port_side):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    fig, axes = figure1.create_figure_1(port_side["panel"], port_side["masks"],
                                        cs_cache=port_side["sweep"])
    try:
        assert len(axes) == 2
        assert [len(ax.get_lines()) for ax in axes] == [5, 5]
    finally:
        plt.close(fig)


def test_figure_frames_index_and_columns(port_side):
    frames = figure1.figure_frames(port_side["panel"], port_side["masks"], port_side["sweep"])
    assert list(frames) == ["All stocks", "Large stocks"]
    for name, frame in frames.items():
        valid = np.asarray(port_side["sweep"][name].cs.month_valid)
        assert isinstance(frame.index, pd.DatetimeIndex) and len(frame) == valid.sum()
        assert np.isfinite(frame.to_numpy()).any(), name
