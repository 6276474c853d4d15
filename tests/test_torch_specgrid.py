"""The spec-grid scenario sweep, the port vs the JAX package.

The JAX package builds an enriched float64 panel from its synthetic
universe (150 firms × 80 months); the port's modules get the same values
as CPU tensors. Compared:

- the lazy cell space (every cell decoded, spec and pair addresses, tiles)
  and the materialized scenario grid,
  the bootstrap month resamples, the resample matrix and the coreset plan:
  equal (host numpy from the same seeded generators);
- each sink's output on the same tile frames: equal;
- ``run_scenarios`` frames at float64: numbers at rtol 1e-8 (atol 1e-13),
  Table 2's pins between the two packages' Gram solves, with the NaN
  pattern, counts, scenario labels and ``refereed`` exactly equal, for the
  default sweep, two winsor levels, two NW weight schemes, bootstrap draws
  (``cells=``) against both of the JAX package's draw routes (the port
  has the batched one only), and the coreset route;
- the bf16 sweep: ``bf16_promoted_months`` and ``refereed`` exact; on a
  float32 panel without the referee the numbers at 1e-4 of their scale (a
  coefficient at ``max(|b|, nw_se)``, a t-stat at ``max(|t|, 1)``): the
  bf16 stats agree to 1e-6 of scale (``test_torch_grams_variants.py``), but
  the JAX package solves them in float64 (its x64 mode upcasts the float32
  stats) and the port in float32; on a float64 panel, where the promoted
  cells are the float64 QR referee's, at rtol 1e-8.

A crash at ``pipeline.specgrid_scenarios`` resumes from the stage
checkpoints with the earlier stages loaded and the frame bit-identical.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from fm_returnprediction_tpu.data.synthetic import generate_synthetic_wrds
from fm_returnprediction_tpu.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu.pipeline import build_panel, build_panel_prepared
from fm_returnprediction_tpu.specgrid import boot as jax_boot
from fm_returnprediction_tpu.specgrid import cellspace as jax_cellspace
from fm_returnprediction_tpu.specgrid import coreset as jax_coreset
from fm_returnprediction_tpu.specgrid import engine as jax_engine
from fm_returnprediction_tpu.specgrid import sinks as jax_sinks
from fm_returnprediction_tpu.specgrid import scenarios as jax_scenarios
from fm_returnprediction_tpu.specgrid.scenarios import run_scenarios as jax_run_scenarios
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig
from fm_returnprediction_tpu_torch.panel.dense import DensePanel
from fm_returnprediction_tpu_torch.resilience import checkpoint as port_checkpoint
from fm_returnprediction_tpu_torch.resilience.faults import FaultPlan, FaultSpec
from fm_returnprediction_tpu_torch.specgrid import (
    boot,
    cellspace,
    coreset,
    engine,
    scenarios,
    sinks,
)
from fm_returnprediction_tpu_torch.specgrid.scenarios import run_scenarios

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def panels():
    capture = {}
    data = generate_synthetic_wrds(JaxSyntheticConfig(n_firms=150, n_months=80))
    build_panel(data, dtype=np.float64, capture=capture)
    panel, factors = build_panel_prepared(capture["dense_base"], capture["compact_daily"],
                                          dtype=np.float64)
    masks = compute_subset_masks(panel)

    def port_side(dtype):
        return (DensePanel(values=torch.from_numpy(np.array(panel.values)).to(dtype),
                           mask=np.asarray(panel.mask), months=np.asarray(panel.months),
                           ids=np.asarray(panel.ids), var_names=list(panel.var_names)),
                {k: torch.from_numpy(np.array(m)) for k, m in masks.items()})

    return dict(jax=(panel, masks), port=port_side(torch.float64), factors=factors,
                port_side=port_side)


def _assert_frames_match(got: pd.DataFrame, want: pd.DataFrame, rtol=1e-8, atol=1e-13):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    floats = [c for c in want.columns if want[c].dtype.kind == "f"]
    rest = [c for c in want.columns if c not in floats]
    for c in rest:
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=c)
    for c in floats:
        g, w = got[c].to_numpy(float), want[c].to_numpy(float)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True, err_msg=c)


def test_cell_space_and_tiles_match(panels):
    factors = panels["factors"]
    kw = dict(subperiods=3, winsor_levels=(1.0, 5.0), weights=("reference", "textbook"),
              bootstrap=3)
    names = ["All stocks", "Large stocks"]
    got = cellspace.scenario_space(factors, names, 80, **kw)
    want = jax_cellspace.scenario_space(factors, names, 80, **kw)
    assert len(got) == len(want) == 2 * 2 * 3 * 2 * 4 * 3
    assert got.dims == want.dims and got.union_predictors == want.union_predictors
    assert (got.n_specs, got.n_pairs) == (want.n_specs, want.n_pairs)
    for i in range(len(got)):
        a, b = got.cell(i), want.cell(i)
        assert a._replace(estimator=None) == b._replace(estimator=None), i
        assert dataclasses.asdict(a.estimator) == dataclasses.asdict(b.estimator)
        assert (got.spec_index(i), got.pair_index(i), got.estimator_index(i)) == \
            (want.spec_index(i), want.pair_index(i), want.estimator_index(i))
    grid = scenarios.scenario_grid(factors, names, 80, subperiods=3)
    want_grid = jax_scenarios.scenario_grid(factors, names, 80, subperiods=3)
    assert [dataclasses.astuple(sp) for sp in grid.specs] == \
        [dataclasses.astuple(sp) for sp in want_grid.specs]
    assert len(grid) == got.n_specs
    tiles = [(t.start, t.stop) for t in got.tiles(37)]
    assert tiles == [(t.start, t.stop) for t in want.tiles(37)]
    assert tiles[-1][1] == len(got)
    with pytest.raises(IndexError):
        got.cell(len(got))


def test_resamples_and_coreset_plan_are_the_jax_draws():
    for draw in (1, 2, 7):
        np.testing.assert_array_equal(engine.block_bootstrap_months(80, draw, seed=3),
                                      jax_engine.block_bootstrap_months(80, draw, seed=3))
    np.testing.assert_array_equal(boot.resample_matrix(80, 5, seed=3),
                                  jax_boot.resample_matrix(80, 5, seed=3))
    assert boot.resample_matrix(80, 1).shape == (0, 80)
    with pytest.raises(ValueError, match="draw 0"):
        engine.block_bootstrap_months(80, 0)

    rng = np.random.default_rng(9)
    t, n, p = 12, 300, 4
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < 0.1] = np.nan
    y = rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.1] = np.nan
    mask = rng.random((t, n)) > 0.2
    mask[3, 40:] = False                          # a month left exact
    got = coreset.coreset_plan(y, x, mask, 64, seed=5)
    want = jax_coreset.coreset_plan(y, x, mask, 64, seed=5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got.exact_months == 1
    uni = rng.random((t, n)) > 0.5
    win = np.arange(t) < 6
    assert got.rate_under(uni, win) == want.rate_under(uni, win)
    for args in ((300, None, None), (300, 10, None), (300, None, 1.0), (50, 500, None)):
        assert coreset.resolve_coreset_m(*args, t=t, q=5) == \
            jax_coreset.resolve_coreset_m(*args, t=t, q=5)


def _tile_frames():
    rng = np.random.default_rng(4)
    frames = []
    for k in range(3):
        cells = np.repeat(np.arange(10 * k, 10 * k + 10), 3)
        frames.append(pd.DataFrame({
            "cell": cells,
            "model": "m",
            "predictor": np.tile(["a", "b", "c"], 10),
            "coef": rng.standard_normal(30),
            # ties in |t| (bootstrap draws of one cell collide) and NaNs
            "tstat": np.round(rng.standard_normal(30) * 3, 1),
            "refereed": rng.random(30) > 0.5,
        }))
        frames[-1].loc[[2, 9], "tstat"] = np.nan
    return frames


@pytest.mark.parametrize("name", ["frame", "topk", "summary", "parquet"])
def test_sinks_match_on_the_same_tiles(name, tmp_path):
    got = sinks.resolve_sink(name, output_dir=tmp_path / "port", topk=7)
    want = jax_sinks.resolve_sink(name, output_dir=tmp_path / "jax", topk=7)
    for frame in _tile_frames():
        got.consume(frame)
        want.consume(frame)
    assert (got.rows_seen, got.cells_seen) == (want.rows_seen, want.cells_seen) == (90, 30)
    a, b = got.finish(), want.finish()
    if name == "parquet":
        assert a.drop(columns="path").equals(b.drop(columns="path"))
        for pa, pb in zip(a["path"], b["path"]):
            assert pd.read_parquet(pa).equals(pd.read_parquet(pb))
    else:
        pd.testing.assert_frame_equal(a, b)
    assert sinks.resolve_sink_name(got) == name


def test_sink_resolution(monkeypatch):
    monkeypatch.setenv("FMRP_SPECGRID_SINK", "summary")
    assert sinks.resolve_sink_name() == "summary"
    assert isinstance(sinks.resolve_sink(), sinks.SummarySink)
    with pytest.raises(ValueError, match="output directory"):
        sinks.resolve_sink("parquet")
    with pytest.raises(ValueError, match="unknown sink"):
        sinks.resolve_sink("csv")


# the JAX package's draw route per sweep; the port has one (batched) route
JAX_BOOT_ROUTE = {"draws_device": "device", "draws_host": "host"}

SWEEPS = {
    "default": {},
    "winsor": dict(winsor_levels=(1.0, 5.0)),
    "weights": dict(weights=("reference", "textbook")),
    "draws_device": dict(cells=100),
    "draws_host": dict(cells=100),
    "coreset": dict(route="coreset", coreset_m=40, seed=2),
    "unfactorized_tiles": dict(factorize="off", tile_cells=10),
}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_run_scenarios_matches_jax(panels, sweep):
    kw = SWEEPS[sweep]
    jpanel, jmasks = panels["jax"]
    ppanel, pmasks = panels["port"]
    jax_kw = dict(kw, boot_route=JAX_BOOT_ROUTE[sweep]) if sweep in JAX_BOOT_ROUTE else kw
    want = jax_run_scenarios(jpanel, jmasks, panels["factors"], **jax_kw)
    got, stats = run_scenarios(ppanel, pmasks, panels["factors"], return_stats=True, **kw)
    _assert_frames_match(got, want)
    assert stats["cells"] == want["cell"].nunique()
    if sweep == "default":
        assert len(want) and want["refereed"].any() and not want["refereed"].all()
        assert stats["gram_factorize"] == "on" and stats["specs_contracted"] == 9
    if sweep == "coreset":
        assert (got["route"] == "coreset").all() and not got["refereed"].any()


def _assert_held_at_scale(got: pd.DataFrame, want: pd.DataFrame, rtol: float):
    """A coefficient held at ``max(|b|, nw_se)``, its t-stat at ``max(|t|,
    1)``, the other numbers relative (as the card-vs-CPU Table 2 check)."""
    se = want["nw_se"].to_numpy(float)
    for c in ("coef", "tstat", "nw_se", "mean_r2", "mean_n"):
        g, w = got[c].to_numpy(float), want[c].to_numpy(float)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
        fin = np.isfinite(w)
        scale = np.abs(w[fin])
        if c == "coef":
            scale = np.fmax(scale, se[fin])
        elif c == "tstat":
            scale = np.maximum(scale, 1.0)
        assert np.all(np.abs(g[fin] - w[fin]) <= rtol * scale), c


@pytest.mark.parametrize("case", ["f32_no_referee", "f32", "f64"])
def test_bf16_sweep_matches_jax(panels, case):
    """The bf16 sweep. Float32 panel without the referee: the bf16 Gram
    solves at 1e-4 of scale (the JAX package solves the float32 stats in
    float64, the port in float32). With it: the same months promoted and
    the same cells refereed (a promoted cell is then the float32 QR
    referee's, whose pinv cutoff at eps·N truncates on raw-unit designs, so
    its numbers are compared on the float64 panel). Float64 panel: every
    number at rtol 1e-8."""
    jpanel, jmasks = panels["jax"]
    dtype = torch.float64 if case == "f64" else torch.float32
    jpanel = dataclasses.replace(
        jpanel, values=np.asarray(jpanel.values, str(dtype).split(".")[1]))
    ppanel, pmasks = panels["port_side"](dtype)
    kw = dict(precision="bf16", referee=case != "f32_no_referee")
    want = jax_run_scenarios(jpanel, jmasks, panels["factors"], **kw)
    got = run_scenarios(ppanel, pmasks, panels["factors"], **kw)
    assert (got["precision"] == "bf16").all()
    np.testing.assert_array_equal(got["bf16_promoted_months"], want["bf16_promoted_months"])
    np.testing.assert_array_equal(got["refereed"], want["refereed"])
    assert got["bf16_promoted_months"].any()
    assert got["refereed"].any() == kw["referee"]
    if case == "f32_no_referee":
        _assert_held_at_scale(got, want, 1e-4)
    elif case == "f64":
        _assert_frames_match(got, want)


def test_sweep_refuses_what_is_not_ported(panels, monkeypatch):
    ppanel, pmasks = panels["port"]
    factors = panels["factors"]
    # the estimator sweep runs (the family is ported; its parity with the
    # reference is held in tests/test_torch_estimators.py)
    frame = run_scenarios(ppanel, pmasks, factors, estimators=["fwl:log_size"])
    assert set(frame["estimator"]) == {"fwl[log_size]"} and frame["coef"].notna().any()
    # the device mesh is ported: FMRP_SPECGRID_MESH over two (virtual) CPU
    # devices runs the OLS sweep sharded and matches the one-device sweep
    # (another summation order, so not bit for bit); with an estimator
    # beyond OLS it refuses, as in the reference
    monkeypatch.setenv("FMRP_VIRTUAL_DEVICES", "2")
    monkeypatch.setenv("FMRP_SPECGRID_MESH", "2")
    meshed = run_scenarios(ppanel, pmasks, factors)
    with pytest.raises(ValueError, match="single-device"):
        run_scenarios(ppanel, pmasks, factors, estimators=["fwl:log_size"])
    monkeypatch.delenv("FMRP_SPECGRID_MESH")
    _assert_frames_match(meshed, run_scenarios(ppanel, pmasks, factors))
    # a leaked non-OLS knob stops the pipeline at Table 2, the paper's OLS
    # parity surface, as in the reference
    monkeypatch.setenv("FMRP_SPECGRID_ESTIMATOR", "iv:log_size~log_bm")
    with pytest.raises(ValueError, match="ols") as exc:
        port_pipeline.run_pipeline(synthetic=True, synthetic_config=SyntheticConfig(
            n_firms=40, n_months=48), device="cpu", make_figure=False, make_deciles=False,
            make_serving=False, make_specgrid=True)
    assert any(str(e.path).endswith("table2.py") for e in exc.traceback)
    monkeypatch.delenv("FMRP_SPECGRID_ESTIMATOR")
    # several processes are ported: FMRP_SPECGRID_PROCS=2 runs the sweep's
    # contractions in two worker processes and matches the one-process sweep
    # (another summation order, so not bit for bit)
    from fm_returnprediction_tpu_torch.specgrid import multiproc

    monkeypatch.setenv("FMRP_SPECGRID_PROCS", "2")
    try:
        multi = run_scenarios(ppanel, pmasks, factors)
        assert multiproc.cached_pool() is not None
        assert {r["device"] for r in multiproc.cached_pool().last_reports} == {"cpu"}
    finally:
        multiproc._close_cached_pool()
    monkeypatch.delenv("FMRP_SPECGRID_PROCS")
    _assert_frames_match(multi, run_scenarios(ppanel, pmasks, factors))
    with pytest.raises(ValueError, match="looser"):
        run_scenarios(ppanel, pmasks, factors, winsor_levels=(0.5,))
    with pytest.raises(ValueError, match="route"):
        run_scenarios(ppanel, pmasks, factors, route="stacked")


def test_crash_at_specgrid_resumes_bit_identical(tmp_path, monkeypatch):
    kw = dict(synthetic=True, synthetic_config=SyntheticConfig(n_firms=50, n_months=72),
              device="cpu", dtype=torch.float64, make_figure=False, make_specgrid=True,
              specgrid_cells=60)
    with FaultPlan({"pipeline.specgrid_scenarios": FaultSpec(times=1)}) as plan:
        with pytest.raises(OSError, match="injected fault"):
            port_pipeline.run_pipeline(checkpoint_dir=tmp_path / "ckpt", **kw)
    assert plan.fired["pipeline.specgrid_scenarios"] == 1
    calls = {"n": 0}
    orig = port_pipeline.table_2_cells

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(port_pipeline, "table_2_cells", counted)
    hits = port_checkpoint.OUTCOMES["hit"]
    resumed = port_pipeline.run_pipeline(checkpoint_dir=tmp_path / "ckpt", **kw)
    assert calls["n"] == 0
    assert port_checkpoint.OUTCOMES["hit"] == hits + 4   # Table 1, Table 2, deciles, serving
    assert (tmp_path / "ckpt" / "specgrid_scenarios.pkl").exists()
    fresh = port_pipeline.run_pipeline(**kw)
    assert resumed.specgrid_scenarios.equals(fresh.specgrid_scenarios)
    assert "draw" in fresh.specgrid_scenarios.columns
    again = port_pipeline.run_pipeline(checkpoint_dir=tmp_path / "ckpt", **kw)
    assert again.specgrid_scenarios.equals(fresh.specgrid_scenarios)
