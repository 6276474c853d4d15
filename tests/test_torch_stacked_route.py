"""The port's stacked-QR reporting route vs the JAX package's, at float64.

The JAX package builds an enriched float64 panel from its synthetic
universe (250 firms × 120 months, every universe with usable decile
months); the port gets the same values as CPU tensors. On the stacked
route (``route="stacked"`` or ``FMRP_SPECGRID_ROUTE=stacked``):

- Table 2's per-cell numbers match JAX's per-cell QR ``fama_macbeth`` at
  rtol 1e-8 and the formatted frame equals JAX's stacked frame, with
  ``FMRP_FUSE_SUBSETS_MB=0`` (split) and with the default budget (fused);
- ``subset_sweep``'s cross-sections, rolled slopes and decile results match
  JAX's stacked sweep at rtol 1e-8 (flags and counts exact), split and
  fused, and the two branches give the same numbers;
- the stacked and the Gram routes' formatted Table 2 agree up to one
  final-digit rounding step at float64 (the reference's own twin test);
  at float32 the QR route's eps·N cutoff truncates raw-unit columns in
  both packages alike, and the port's float32 stacked frame equals JAX's;
- the guard records the same sentinel sites as JAX on each branch;
- ``reporting.fusion`` parses its budget as JAX's does, and ``coreset`` is
  refused on both reporting surfaces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu.guard import checks as jax_checks
from fm_returnprediction_tpu.models.lewellen import MODELS, model_columns
from fm_returnprediction_tpu.ops.fama_macbeth import fama_macbeth as jax_fama_macbeth
from fm_returnprediction_tpu.panel.dense import DensePanel as JaxDensePanel
from fm_returnprediction_tpu.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu.pipeline import build_panel, build_panel_prepared
from fm_returnprediction_tpu.reporting import fusion as jax_fusion
from fm_returnprediction_tpu.reporting.figure1 import subset_sweep as jax_subset_sweep
from fm_returnprediction_tpu.reporting.table2 import build_table_2 as jax_build_table_2
from fm_returnprediction_tpu_torch.guard import checks as port_checks
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.reporting import fusion
from fm_returnprediction_tpu_torch.reporting.figure1 import subset_sweep
from fm_returnprediction_tpu_torch.reporting.table2 import build_table_2, table_2_cells
from fm_returnprediction_tpu_torch.specgrid import resolve_route

pytestmark = pytest.mark.torch_port

BRANCHES = {"split": "0", "fused": None}


@pytest.fixture(scope="module")
def jax_side():
    capture = {}
    data = generate_synthetic_wrds(SyntheticConfig(n_firms=250, n_months=120))
    build_panel(data, dtype=np.float64, capture=capture)
    panel, factors = build_panel_prepared(capture["dense_base"], capture["compact_daily"],
                                          dtype=np.float64)
    return dict(panel=panel, factors=factors, masks=compute_subset_masks(panel))


@pytest.fixture(scope="module")
def port_side(jax_side):
    jp = jax_side["panel"]
    panel = DensePanel(values=torch.from_numpy(np.array(jp.values)),
                       mask=np.asarray(jp.mask), months=np.asarray(jp.months),
                       ids=np.asarray(jp.ids), var_names=list(jp.var_names))
    masks = {k: torch.from_numpy(np.array(m)) for k, m in jax_side["masks"].items()}
    return dict(panel=panel, masks=masks)


@pytest.fixture
def branch(request, monkeypatch):
    budget = BRANCHES[request.param]
    if budget is None:
        monkeypatch.delenv("FMRP_FUSE_SUBSETS_MB", raising=False)
    else:
        monkeypatch.setenv("FMRP_FUSE_SUBSETS_MB", budget)
    return request.param


def _close(got, want, rtol, what=""):
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True, err_msg=what)


def _formatted_frames_close(a: pd.DataFrame, b: pd.DataFrame, tol: float = 1.5e-3) -> None:
    """Layout-identical and cell-wise equal up to one final-digit rounding
    step (the reference's cross-route comparison)."""
    assert a.index.equals(b.index)
    assert a.columns.equals(b.columns)
    for col in a.columns:
        for idx in a.index:
            va, vb = a.loc[idx, col], b.loc[idx, col]
            if va == vb:
                continue
            assert va != "" and vb != "", (idx, col, va, vb)
            assert abs(float(str(va).replace(",", "")) - float(str(vb).replace(",", ""))) <= tol


def _fused_here(port_side, n_designs: int, p: int) -> bool:
    panel = port_side["panel"]
    t, n = panel.values.shape[:2]
    return fusion.fuse_over_subsets(len(port_side["masks"]) * n_designs, t, n, p, 8)


@pytest.mark.parametrize("branch", list(BRANCHES), indirect=True)
def test_table2_stacked_matches_jax(jax_side, port_side, branch):
    assert _fused_here(port_side, 1, 14) == (branch == "fused")
    cells = table_2_cells(port_side["panel"], port_side["masks"], jax_side["factors"],
                          route="stacked")
    jp = jax_side["panel"]
    y = jnp.asarray(jp.var("retx"))
    for model in MODELS:
        x = jnp.asarray(jp.select(model_columns(model, jax_side["factors"])))
        for name, mask in jax_side["masks"].items():
            _, fm = jax_fama_macbeth(y, x, jnp.asarray(mask), nw_lags=4, guard=False)
            for key in ("coef", "tstat", "nw_se", "mean_r2", "mean_n"):
                _close(cells[(model.name, name)][key], getattr(fm, key), 1e-8,
                       f"{model.name} {name} {key}")
    got = build_table_2(port_side["panel"], port_side["masks"], jax_side["factors"],
                        route="stacked")
    want = jax_build_table_2(jp, jax_side["masks"], jax_side["factors"], route="stacked")
    assert got.equals(want)


def test_table2_fused_and_split_agree(jax_side, port_side, monkeypatch):
    args = (port_side["panel"], port_side["masks"], jax_side["factors"])
    monkeypatch.setenv("FMRP_FUSE_SUBSETS_MB", "0")
    split = table_2_cells(*args, route="stacked")
    split_frame = build_table_2(*args, route="stacked")
    monkeypatch.delenv("FMRP_FUSE_SUBSETS_MB")
    fused = table_2_cells(*args, route="stacked")
    assert build_table_2(*args, route="stacked").equals(split_frame)
    for key, cell in split.items():
        for name, value in cell.items():
            _close(fused[key][name], value, 1e-12, f"{key} {name}")


def test_table2_stacked_and_gram_routes_agree(jax_side, port_side):
    args = (port_side["panel"], port_side["masks"], jax_side["factors"])
    _formatted_frames_close(build_table_2(*args, route="gram"),
                            build_table_2(*args, route="stacked"))


def test_table2_stacked_matches_jax_at_float32(jax_side, port_side):
    jp = jax_side["panel"]
    values = np.asarray(jp.values, dtype=np.float32)
    jp32 = JaxDensePanel(values=values, mask=np.asarray(jp.mask), months=np.asarray(jp.months),
                         ids=np.asarray(jp.ids), var_names=list(jp.var_names))
    pp = port_side["panel"]
    pp32 = DensePanel(values=torch.from_numpy(values), mask=pp.mask, months=pp.months,
                      ids=pp.ids, var_names=pp.var_names)
    got = build_table_2(pp32, port_side["masks"], jax_side["factors"], route="stacked")
    want = jax_build_table_2(jp32, jax_side["masks"], jax_side["factors"], route="stacked")
    _formatted_frames_close(got, want)


def _sweep_close(got, want, rtol, what):
    assert list(got) == list(want), what
    for name in want:
        g, w = got[name], want[name]
        np.testing.assert_array_equal(np.asarray(g.cs.month_valid), np.asarray(w.cs.month_valid))
        np.testing.assert_array_equal(np.asarray(g.cs.n_obs), np.asarray(w.cs.n_obs))
        for leaf in ("slopes", "intercept", "r2"):
            _close(getattr(g.cs, leaf), getattr(w.cs, leaf), rtol, f"{what} {name} {leaf}")
        _close(g.rolled, w.rolled, rtol, f"{what} {name} rolled")
        np.testing.assert_array_equal(np.asarray(g.deciles.decile_counts),
                                      np.asarray(w.deciles.decile_counts))
        np.testing.assert_array_equal(np.asarray(g.deciles.month_valid),
                                      np.asarray(w.deciles.month_valid))
        for leaf in ("decile_returns", "mean_returns", "spread", "spread_tstat"):
            _close(getattr(g.deciles, leaf), getattr(w.deciles, leaf), rtol,
                   f"{what} {name} {leaf}")
        assert int(g.deciles.n_months) == int(w.deciles.n_months)
        assert tuple(g.decile_params) == tuple(w.decile_params)


@pytest.mark.parametrize("branch", list(BRANCHES), indirect=True)
def test_subset_sweep_stacked_matches_jax(jax_side, port_side, branch):
    assert _fused_here(port_side, 1, 5) == (branch == "fused")
    names = list(port_side["masks"])
    got = subset_sweep(port_side["panel"], port_side["masks"], names, route="stacked")
    want = jax_subset_sweep(jax_side["panel"], jax_side["masks"], names, route="stacked")
    _sweep_close(got, want, 1e-8, branch)


def test_subset_sweep_fused_and_split_agree(port_side, monkeypatch):
    names = list(port_side["masks"])
    monkeypatch.setenv("FMRP_FUSE_SUBSETS_MB", "0")
    split = subset_sweep(port_side["panel"], port_side["masks"], names, route="stacked")
    monkeypatch.delenv("FMRP_FUSE_SUBSETS_MB")
    fused = subset_sweep(port_side["panel"], port_side["masks"], names, route="stacked")
    _sweep_close(fused, split, 1e-12, "fused vs split")


def test_route_comes_from_the_environment(jax_side, port_side, monkeypatch):
    args = (port_side["panel"], port_side["masks"], jax_side["factors"])
    stacked = build_table_2(*args, route="stacked")
    monkeypatch.setenv("FMRP_SPECGRID_ROUTE", "stacked")
    assert resolve_route() == "stacked"
    assert build_table_2(*args).equals(stacked)
    assert resolve_route("gram") == "gram"          # the argument wins


class _SiteLog:
    """Logs the sites a package's ``checks.record`` records (JAX: a record
    whose counters are tracers, inside an outer program, is skipped)."""

    def __init__(self, checks):
        self.checks, self.orig, self.sites = checks, checks.record, []

    def __enter__(self):
        def record(site, values):
            if not any(isinstance(v, jax.core.Tracer) for v in values.values()):
                self.sites.append(site)
            return self.orig(site, values)

        self.checks.record = record
        return self

    def __exit__(self, *exc):
        self.checks.record = self.orig


@pytest.mark.parametrize("branch", list(BRANCHES), indirect=True)
def test_sentinel_sites_match_jax(jax_side, port_side, branch):
    names = list(port_side["masks"])
    with jax_checks.guards(True), _SiteLog(jax_checks) as jax_log:
        jax_build_table_2(jax_side["panel"], jax_side["masks"], jax_side["factors"],
                          route="stacked")
        jax_subset_sweep(jax_side["panel"], jax_side["masks"], names, route="stacked")
    with port_checks.guards(True), _SiteLog(port_checks) as port_log:
        build_table_2(port_side["panel"], port_side["masks"], jax_side["factors"],
                      route="stacked")
        subset_sweep(port_side["panel"], port_side["masks"], names, route="stacked")
    jax_checks.reset()
    port_checks.reset()
    assert port_log.sites == jax_log.sites
    assert port_log.sites[-1] == "figure.subset_sweep"
    assert ("table2.fm_sweep" in port_log.sites) == (branch == "fused")


@pytest.mark.parametrize("where", ["argument", "environment"])
def test_coreset_is_refused_on_the_reporting_routes(jax_side, port_side, where, monkeypatch):
    route = "coreset" if where == "argument" else None
    if where == "environment":
        monkeypatch.setenv("FMRP_SPECGRID_ROUTE", "coreset")
    with pytest.raises(ValueError, match="not available here"):
        build_table_2(port_side["panel"], port_side["masks"], jax_side["factors"], route=route)
    with pytest.raises(ValueError, match="not available here"):
        subset_sweep(port_side["panel"], port_side["masks"], ["All stocks"], route=route)
    assert resolve_route(route) == "coreset"          # the scenario engine takes it
    with pytest.raises(ValueError, match="expected 'gram'"):
        resolve_route("bogus")


# -- the fusion budget (the reference's tests/test_fusion_policy.py cases) --


def test_footprint_model():
    assert fusion.stacked_design_bytes(3, 600, 22000, 14, 4) == 3 * 600 * 22000 * 16 * 4
    assert (fusion.stacked_design_bytes(3, 600, 22000, 14, 4)
            == jax_fusion.stacked_design_bytes(3, 600, 22000, 14, 4))


def test_default_budget_splits_real_shape_and_fuses_toy(monkeypatch):
    monkeypatch.delenv("FMRP_FUSE_SUBSETS_MB", raising=False)
    assert not fusion.fuse_over_subsets(3, 600, 22000, 14, 4)
    assert fusion.fuse_over_subsets(3, 600, 800, 14, 4)
    assert fusion.fuse_over_subsets(3, 84, 40, 14, 8)


@pytest.mark.parametrize("raw, want_mb", [("0", 0.0), ("1048576", 1048576.0), ("-16", 0.0),
                                          ("2.5", 2.5)])
def test_env_override_matches_jax(raw, want_mb, monkeypatch):
    monkeypatch.setenv("FMRP_FUSE_SUBSETS_MB", raw)
    assert fusion.fuse_budget_bytes() == jax_fusion.fuse_budget_bytes() == want_mb * 2**20
    assert fusion.fuse_over_subsets(1, 1, 1, 1, 4) == (want_mb > 0)
    assert (fusion.fuse_over_subsets(3, 600, 22000, 14, 4)
            == jax_fusion.fuse_over_subsets(3, 600, 22000, 14, 4))


def test_malformed_override_warns_and_uses_default(monkeypatch):
    monkeypatch.setenv("FMRP_FUSE_SUBSETS_MB", "512MB")
    with pytest.warns(RuntimeWarning, match="FMRP_FUSE_SUBSETS_MB"):
        assert fusion.fuse_budget_bytes() == 512.0 * 2**20


def test_budget_boundary_is_inclusive(monkeypatch):
    needed = fusion.stacked_design_bytes(2, 10, 100, 3, 4)
    monkeypatch.setenv("FMRP_FUSE_SUBSETS_MB", str(needed / 2**20))
    assert fusion.fuse_over_subsets(2, 10, 100, 3, 4)
    monkeypatch.setenv("FMRP_FUSE_SUBSETS_MB", str((needed - 1) / 2**20))
    assert not fusion.fuse_over_subsets(2, 10, 100, 3, 4)
