"""The port's public functions take the JAX package's calls.

Each test makes one call the way the reference's own callers write it —
the same positional arguments, the reference's defaults — through both
packages on one seeded synthetic frame set, float64 on the CPU (the port
gets ``device="cpu"``, its one keyword-only extra), and holds the results:

- ``get_factors(merged, crsp_d, crsp_index_d, dtype=np.float64)``, the
  frames route (the JAX package's own test call): panel values at 1e-10,
  the factor map equal, and the same panel as the prebuilt route bit for
  bit;
- ``INCLUDE_TURNOVER=1`` through ``get_factors``, ``build_panel_columnar``
  and ``build_panel_prepared`` with ``include_turnover`` left at its
  default: the 16th characteristic, as the reference's with the flag on;
- ``build_panel(data, np.float64, None)`` positionally;
- the weekly sums with shuffled and out-of-range week ids;
- ``create_figure_1(panel, masks, True, out)`` writes ``figure_1.pdf``;
- ``fama_macbeth(guard=...)`` and ``monthly_cs_ols(guard=...)`` arm or
  disarm the sentinels for the call, whatever the switch, as the
  reference's do.
"""

import jax
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu import pipeline as jax_pipeline
from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu.guard import checks as jax_checks
from fm_returnprediction_tpu.ops import daily_kernels as jax_daily
from fm_returnprediction_tpu.ops.fama_macbeth import fama_macbeth as jax_fama_macbeth
from fm_returnprediction_tpu.ops.ols import monthly_cs_ols as jax_monthly_cs_ols
from fm_returnprediction_tpu.panel import characteristics as jax_chars
from fm_returnprediction_tpu.panel.columnar import build_panel_columnar as jax_columnar
from fm_returnprediction_tpu.panel.transform_compustat import (
    add_report_date,
    calc_book_equity,
    expand_compustat_annual_to_monthly,
    merge_CRSP_and_Compustat,
)
from fm_returnprediction_tpu.panel.transform_crsp import calculate_market_equity
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.convert import prepared_from_numpy
from fm_returnprediction_tpu_torch.data.synthetic import write_synthetic_cache
from fm_returnprediction_tpu_torch.guard import checks as port_checks
from fm_returnprediction_tpu_torch.ops import daily_kernels as port_daily
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth
from fm_returnprediction_tpu_torch.ops.ols import monthly_cs_ols
from fm_returnprediction_tpu_torch.panel import characteristics as port_chars
from fm_returnprediction_tpu_torch.panel.columnar import build_panel_columnar
from fm_returnprediction_tpu_torch.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu_torch.reporting.figure1 import create_figure_1

pytestmark = pytest.mark.torch_port

CONFIG = SyntheticConfig(n_firms=30, n_months=48)
CPU = "cpu"


def _merged(wrds):
    """The merged monthly frame the reference's tests hand ``get_factors``."""
    crsp = calculate_market_equity(wrds["crsp_m"])
    comp = expand_compustat_annual_to_monthly(
        calc_book_equity(add_report_date(wrds["comp"].copy())))
    merged = merge_CRSP_and_Compustat(crsp, comp, wrds["ccm"])
    merged["mthcaldt"] = merged["jdate"]
    return merged


@pytest.fixture(scope="module")
def frames():
    wrds = generate_synthetic_wrds(CONFIG)
    return wrds, _merged(wrds)


def _values(panel) -> np.ndarray:
    v = panel.values
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _panels_close(got, want, rtol=1e-10):
    assert list(got.var_names) == list(want.var_names)
    np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids))
    np.testing.assert_array_equal(np.asarray(got.months), np.asarray(want.months))
    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(want.mask))
    g, w = _values(got), _values(want)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12, equal_nan=True)


def test_get_factors_from_raw_frames_as_the_reference_calls_it(frames):
    wrds, merged = frames
    want, want_factors = jax_chars.get_factors(merged.copy(), wrds["crsp_d"],
                                               wrds["crsp_index_d"], dtype=np.float64)
    capture = {}
    got, factors = port_chars.get_factors(merged.copy(), wrds["crsp_d"], wrds["crsp_index_d"],
                                          dtype=np.float64, capture=capture, device=CPU)
    assert got.values.dtype == torch.float64
    assert factors == want_factors
    _panels_close(got, want)
    # the prebuilt route on the frames route's own base panel: the same bits
    daily = port_chars.build_compact_daily(wrds["crsp_d"], wrds["crsp_index_d"],
                                           got.months, dtype=np.float64)
    again, _ = port_chars.get_factors(None, None, None, np.float64, device=CPU,
                                      dense_base=capture["dense_base"], compact_daily=daily)
    assert torch.equal(torch.nan_to_num(again.values, nan=7.0),
                       torch.nan_to_num(got.values, nan=7.0))


def test_get_factors_refuses_a_mesh_with_a_firm_chunk(frames):
    wrds, merged = frames
    with pytest.raises(ValueError, match="firm_chunk"):
        port_chars.get_factors(merged, wrds["crsp_d"], wrds["crsp_index_d"], np.float64,
                               object(), 64, device=CPU)


def _turnover_checked(got, got_factors, want, want_factors):
    assert port_chars.TURNOVER_COLUMN in got.var_names
    assert got_factors == want_factors
    assert got_factors[port_chars.TURNOVER_LABEL] == port_chars.TURNOVER_COLUMN
    _panels_close(got, want)


def test_include_turnover_setting_reaches_get_factors(frames, monkeypatch):
    wrds, merged = frames
    monkeypatch.setenv("INCLUDE_TURNOVER", "1")
    got, got_factors = port_chars.get_factors(merged.copy(), wrds["crsp_d"],
                                              wrds["crsp_index_d"], np.float64, device=CPU)
    want, want_factors = jax_chars.get_factors(merged.copy(), wrds["crsp_d"],
                                               wrds["crsp_index_d"], np.float64,
                                               include_turnover=True)
    _turnover_checked(got, got_factors, want, want_factors)


def test_include_turnover_setting_reaches_build_panel_columnar(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    write_synthetic_cache(raw, CONFIG)
    monkeypatch.setenv("INCLUDE_TURNOVER", "1")
    got, got_factors = build_panel_columnar(raw, np.float64, device=CPU)
    want, want_factors = jax_columnar(raw, np.float64, include_turnover=True)
    _turnover_checked(got, got_factors, want, want_factors)


def test_include_turnover_setting_reaches_build_panel_prepared(frames, monkeypatch):
    wrds, _ = frames
    capture = {}
    want, want_factors = jax_pipeline.build_panel(dict(wrds), np.float64,
                                                  include_turnover=True, capture=capture)
    base, daily = prepared_from_numpy(capture["dense_base"], capture["compact_daily"])
    monkeypatch.setenv("INCLUDE_TURNOVER", "1")
    got, got_factors = port_pipeline.build_panel_prepared(base, daily, np.float64, device=CPU)
    _turnover_checked(got, got_factors, want, want_factors)
    monkeypatch.setenv("INCLUDE_TURNOVER", "0")
    off, off_factors = port_pipeline.build_panel_prepared(
        *prepared_from_numpy(capture["dense_base"], capture["compact_daily"]), np.float64,
        device=CPU)
    assert port_chars.TURNOVER_COLUMN not in off.var_names
    assert port_chars.TURNOVER_LABEL not in off_factors


def test_build_panel_takes_the_reference_positional_call(frames):
    wrds, _ = frames
    want, want_factors = jax_pipeline.build_panel(dict(wrds), np.float64, None)
    got, got_factors = port_pipeline.build_panel(dict(wrds), np.float64, None, device=CPU)
    assert got_factors == want_factors
    _panels_close(got, want)


@pytest.mark.parametrize("order", ["shuffled", "out of range"])
def test_weekly_sums_take_any_week_order(order):
    """The six weekly partial sums with the days' week ids shuffled, or with
    some ids past ``n_weeks`` (their days dropped), against the
    reference's ``segment_sum``; then the betas."""
    rng = np.random.default_rng(21)
    d, n, n_weeks = 120, 9, 24
    ret = np.where(rng.random((d, n)) > 0.05, rng.standard_normal((d, n)) * 0.02, np.nan)
    mask = rng.random((d, n)) > 0.2
    mkt = rng.standard_normal(d) * 0.01
    mkt_present = rng.random(d) > 0.05
    week_id = (np.arange(d) // 5).astype(np.int32)
    if order == "shuffled":
        week_id = rng.permutation(week_id)
    else:
        week_id[rng.random(d) < 0.1] = n_weeks + 3
    week_month_id = np.minimum(np.arange(n_weeks) // 4, 5).astype(np.int32)
    t = torch.from_numpy
    got = port_daily.weekly_partial_sums(t(ret), t(mask), t(mkt), t(week_id), n_weeks,
                                         mkt_present=t(mkt_present))
    want = jax_daily.weekly_partial_sums(ret, mask, mkt, week_id, n_weeks,
                                         mkt_present=mkt_present)
    for g, w in zip(got, want):
        assert g.shape == (n_weeks, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-15)
    beta = port_daily.weekly_rolling_beta_monthly(t(ret), t(mask), t(mkt), t(week_id),
                                                  n_weeks, t(week_month_id), 6, 8,
                                                  t(mkt_present))
    want_beta = jax_daily.weekly_rolling_beta_monthly(ret, mask, mkt, week_id, n_weeks,
                                                      week_month_id, 6, 8, mkt_present)
    np.testing.assert_allclose(beta.numpy(), np.asarray(want_beta), rtol=1e-10, atol=1e-12,
                               equal_nan=True)


def test_create_figure_1_saves_the_plot(frames, tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    wrds, merged = frames
    panel, _ = port_chars.get_factors(merged.copy(), wrds["crsp_d"], wrds["crsp_index_d"],
                                      np.float64, device=CPU)
    masks = compute_subset_masks(panel)
    fig, axes = create_figure_1(panel, masks, True, tmp_path / "out")
    try:
        assert len(axes) == 2
        pdf = tmp_path / "out" / "figure_1.pdf"
        assert pdf.exists() and pdf.stat().st_size > 0
        assert pdf.read_bytes().startswith(b"%PDF")
    finally:
        plt.close(fig)
    fig, _ = create_figure_1(panel, masks, False, tmp_path / "none")
    plt.close(fig)
    assert not (tmp_path / "none").exists()


class _Sites:
    """Logs the sites a package's ``checks.record`` queues. JAX skips a
    record whose counters are tracers (an inner call inside an outer
    program): the log skips those too."""

    def __init__(self, checks, monkeypatch):
        self.sites = []
        orig = checks.record

        def record(site, values):
            if not any(isinstance(v, jax.core.Tracer) for v in values.values()):
                self.sites.append(site)
            return orig(site, values)

        monkeypatch.setattr(checks, "record", record)


def _fm_inputs():
    rng = np.random.default_rng(5)
    t, n, p = 24, 60, 3
    x = rng.standard_normal((t, n, p))
    y = x @ np.array([0.3, -0.2, 0.1]) + rng.standard_normal((t, n))
    mask = rng.random((t, n)) > 0.1
    return y, x, mask


@pytest.mark.parametrize("active, guard", [(True, False), (False, True), (True, None),
                                           (False, None)])
def test_guard_argument_overrides_the_switch(monkeypatch, active, guard):
    """``fama_macbeth(guard=...)`` and ``monthly_cs_ols(guard=...)``: the
    same sites queued as the reference's for each switch and argument, and
    the same numbers whatever the guard."""
    y, x, mask = _fm_inputs()
    port_sites, jax_sites = _Sites(port_checks, monkeypatch), _Sites(jax_checks, monkeypatch)
    t = torch.from_numpy
    with port_checks.guards(active), jax_checks.guards(active):
        _, got = fama_macbeth(t(y), t(x), t(mask), guard=guard)
        _, want = jax_fama_macbeth(y, x, mask, guard=guard)
        got_cs = monthly_cs_ols(t(y), t(x), t(mask), "qr", guard)
        want_cs = jax_monthly_cs_ols(y, x, mask, "qr", guard)
    port_checks.drain()
    jax_checks.drain()
    armed = active if guard is None else guard
    assert port_sites.sites == jax_sites.sites
    assert port_sites.sites == (["ols.fama_macbeth", "ols.monthly_cs_ols"] if armed else [])
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=1e-10)
    np.testing.assert_allclose(got_cs.slopes.numpy(), np.asarray(want_cs.slopes), rtol=1e-10,
                               atol=1e-12)


def test_run_pipeline_binds_the_reference_positional_order():
    """``run_pipeline``'s positional parameters are the reference's
    (``raw_data_dir`` first); the prepared inputs and the device are
    keyword-only."""
    import inspect

    sig = inspect.signature(port_pipeline.run_pipeline)
    ref = inspect.signature(jax_pipeline.run_pipeline)
    bound = sig.bind("raw", "out", False, None, np.float64)
    assert bound.arguments == ref.bind("raw", "out", False, None, np.float64).arguments
    keyword_only = {n for n, p in sig.parameters.items() if p.kind is p.KEYWORD_ONLY}
    assert keyword_only == {"device", "include_turnover", "dense_base", "compact_daily"}
