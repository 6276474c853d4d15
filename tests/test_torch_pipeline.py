"""The port's slice as a whole vs the JAX package's, and the port's guards.

The JAX package builds the prepared inputs (``build_panel`` with
``capture``) from its synthetic universe; the same dense base panel and
compact daily strips then go through the JAX warm path
(``build_panel_prepared`` → ``compute_subset_masks`` → ``build_table_2``)
and through the port's ``run_pipeline(device="cpu", dtype=torch.float64)``.
Enriched panel values agree at rtol 1e-10 with identical NaN patterns, the
masks exactly, Table 2's per-cell numbers at rtol 1e-8, and the formatted
frames are equal. The JAX warm path's later stages (``build_table_1``, the
``subset_sweep``, Figure 1's ``rolling_slopes``, ``build_decile_table``,
``build_serving_state_from_panel``, the scenario sweep ``run_scenarios``,
the backtest ``run_backtest_scenarios``) run on the same JAX panel: Table 1
at rtol 1e-10 with N exact, the figure frames, decile table, serving state,
scenario frame and backtest frame at rtol 1e-8 with counts, labels and
flags exact.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.backtest import run_backtest_scenarios
from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu.models.lewellen import MODELS
from fm_returnprediction_tpu.panel.subsets import compute_subset_masks
from fm_returnprediction_tpu.pipeline import build_panel, build_panel_prepared
from fm_returnprediction_tpu.reporting.deciles import build_decile_table
from fm_returnprediction_tpu.reporting.figure1 import rolling_slopes, subset_sweep
from fm_returnprediction_tpu.reporting.table1 import build_table_1
from fm_returnprediction_tpu.reporting.table2 import build_table_2
from fm_returnprediction_tpu.serving.state import build_serving_state_from_panel
from fm_returnprediction_tpu.specgrid import run_spec_grid, table2_grid
from fm_returnprediction_tpu.specgrid.scenarios import run_scenarios
from fm_returnprediction_tpu_torch.convert import prepared_from_numpy
from fm_returnprediction_tpu_torch.pipeline import run_pipeline

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_run():
    capture = {}
    data = generate_synthetic_wrds(SyntheticConfig(n_firms=60, n_months=130))
    build_panel(data, dtype=np.float64, capture=capture)
    base, daily = capture["dense_base"], capture["compact_daily"]
    panel, factors = build_panel_prepared(base, daily, dtype=np.float64)
    masks = compute_subset_masks(panel)
    table = build_table_2(panel, masks, factors)
    grid = table2_grid(factors, subsets=list(masks))
    res = run_spec_grid(jnp.asarray(panel.var("retx")),
                        jnp.asarray(panel.select(grid.union_predictors)), masks, grid)
    cells = {}
    for mi, model in enumerate(MODELS):
        for si, name in enumerate(masks):
            fm = res.spec_summary(grid, mi * len(masks) + si)
            cells[(model.name, name)] = fm
    sweep = subset_sweep(panel, masks, list(masks))
    figure = {name: rolling_slopes(panel, masks[name], cs=sweep[name].cs,
                                   rolled=sweep[name].rolled)
              for name in ("All stocks", "Large stocks")}
    return dict(base=base, daily=daily, panel=panel, factors=factors,
                masks=masks, table=table, cells=cells,
                table_1=build_table_1(panel, masks, factors), figure=figure,
                deciles=build_decile_table(panel, masks, cs_cache=sweep),
                serving=build_serving_state_from_panel(
                    panel, masks["All stocks"], cs=sweep["All stocks"].cs))


@pytest.fixture(scope="module")
def port_run(jax_run):
    base, daily = prepared_from_numpy(jax_run["base"], jax_run["daily"])
    return run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64)


def test_enriched_panel_matches(jax_run, port_run):
    want = jax_run["panel"]
    got = port_run.panel
    assert got.var_names == want.var_names
    assert port_run.factors_dict == jax_run["factors"]
    g, w = got.values.numpy(), np.asarray(want.values)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=1e-10, atol=0, equal_nan=True)


def test_subset_masks_identical(jax_run, port_run):
    assert list(port_run.subset_masks) == list(jax_run["masks"])
    for name, mask in jax_run["masks"].items():
        np.testing.assert_array_equal(port_run.subset_masks[name].numpy(),
                                      np.asarray(mask), err_msg=name)


def test_table2_cells_match(jax_run, port_run):
    assert set(port_run.table_2_cells) == set(jax_run["cells"])
    for key, fm in jax_run["cells"].items():
        cell = port_run.table_2_cells[key]
        for name in ("coef", "tstat", "mean_r2", "mean_n"):
            got = np.asarray(cell[name], float)
            want = np.asarray(getattr(fm, name), float)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=0,
                                       equal_nan=True, err_msg=f"{key} {name}")


def test_formatted_table2_equal(jax_run, port_run):
    assert port_run.table_2.equals(jax_run["table"])


def _assert_frames_close(got, want, rtol, exact_rows=()):
    assert list(got.index) == list(want.index)
    assert got.index.name == want.index.name
    assert list(got.columns) == list(want.columns)
    g = got.to_numpy(dtype=float)
    w = want.to_numpy(dtype=float)
    exact = np.isin(np.asarray(got.index), list(exact_rows))
    np.testing.assert_array_equal(g[exact], w[exact])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[~exact], w[~exact], rtol=rtol, atol=0, equal_nan=True)


def test_table1_matches(jax_run, port_run):
    got, want = port_run.table_1, jax_run["table_1"]
    assert got.shape == (15, 9)
    n_cols = [c for c in got.columns if c[1] == "N"]
    np.testing.assert_array_equal(got[n_cols].to_numpy(), want[n_cols].to_numpy())
    _assert_frames_close(got.drop(columns=n_cols), want.drop(columns=n_cols), 1e-10)


def test_figure_frames_match(jax_run, port_run):
    assert list(port_run.figure_1) == list(jax_run["figure"])
    for name, want in jax_run["figure"].items():
        got = port_run.figure_1[name]
        assert got.index.equals(want.index), name
        _assert_frames_close(got, want, 1e-8)


def test_decile_table_matches(jax_run, port_run):
    assert port_run.decile_table.shape == (13, 3)
    _assert_frames_close(port_run.decile_table, jax_run["deciles"], 1e-8,
                         exact_rows=("Months",))


def test_serving_state_matches(jax_run, port_run):
    got, want = port_run.serving_state, jax_run["serving"]
    assert got.xvars == want.xvars and got.coef.shape == want.coef.shape
    np.testing.assert_array_equal(got.months, want.months)
    for name in ("coef", "slopes_bar", "intercept_bar", "gram", "moment", "ysum", "yy"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0, equal_nan=True, err_msg=name)
    for name in ("n_obs", "month_valid"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the support bounds are minima/maxima of the enriched panel, so they
    # agree as closely as the two panels do (rtol 1e-10, test above); on a
    # shared panel they are exact (tests/test_torch_reporting.py)
    for name in ("x_lo", "x_hi"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0, err_msg=name)


def test_sweep_covers_every_universe(port_run):
    assert list(port_run.sweep) == list(port_run.subset_masks)
    for entry in port_run.sweep.values():
        assert entry.decile_params == (120, 60, 10, 50)
        assert entry.deciles is not None


@pytest.mark.parametrize("make_figure", [True, False])
def test_pipeline_without_deciles(jax_run, port_run, make_figure):
    """Without the decile table the sweep covers only the figure's two
    universes, or none when the figure is off too (the serving state then
    fits its own cross-section); what runs agrees with the full run."""
    base, daily = prepared_from_numpy(jax_run["base"], jax_run["daily"])
    res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64,
                       make_figure=make_figure, make_deciles=False)
    assert res.decile_table is None and "decile_table" not in res.stage_seconds
    if make_figure:
        assert set(res.sweep) == {"All stocks", "Large stocks"}
        assert all(entry.deciles is None for entry in res.sweep.values())
        assert list(res.figure_1) == list(port_run.figure_1)
        for name, want in port_run.figure_1.items():
            assert res.figure_1[name].index.equals(want.index), name
            _assert_frames_close(res.figure_1[name], want, 1e-12)
    else:
        assert res.sweep == {} and res.figure_1 is None
        assert "figure_cs" not in res.stage_seconds
    got, want = res.serving_state, port_run.serving_state
    for name in ("coef", "slopes_bar", "intercept_bar"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-8,
                                   atol=0, equal_nan=True, err_msg=name)
    for name in ("n_obs", "month_valid", "x_lo", "x_hi"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_specgrid_scenarios_match(jax_run):
    """``run_pipeline(make_specgrid=True)`` against the JAX sweep on the
    JAX panel: the default sweep (3 models × 3 universes × full sample and
    two halves) and one grown to 100 cells by bootstrap draws."""
    base, daily = prepared_from_numpy(jax_run["base"], jax_run["daily"])
    for cells in (None, 100):
        res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64, make_figure=False,
                           make_deciles=False, make_serving=False, make_specgrid=True,
                           specgrid_cells=cells)
        want = run_scenarios(jax_run["panel"], jax_run["masks"], jax_run["factors"],
                             cells=cells)
        got = res.specgrid_scenarios
        assert "specgrid" in res.stage_seconds
        assert list(got.columns) == list(want.columns) and len(got) == len(want)
        floats = [c for c in want.columns if want[c].dtype.kind == "f"]
        for c in want.columns:
            g, w = got[c].to_numpy(), want[c].to_numpy()
            if c in floats:
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
                np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-13, equal_nan=True,
                                           err_msg=c)
            else:
                np.testing.assert_array_equal(g, w, err_msg=c)
        assert got["cell"].nunique() == (27 if cells is None else 108)


def test_backtest_table_matches(jax_run):
    """``run_pipeline(make_backtest=True)`` against the JAX package's
    backtest stage on the JAX panel: 2 schemes × 3 models × 3 universes ×
    EW/VW, one row per cell."""
    base, daily = prepared_from_numpy(jax_run["base"], jax_run["daily"])
    kw = dict(backtest_schemes="expanding,rolling60", backtest_quantiles=5)
    res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64, make_figure=False,
                       make_deciles=False, make_serving=False, make_backtest=True, **kw)
    want = run_backtest_scenarios(jax_run["panel"], jax_run["masks"], jax_run["factors"],
                                  schemes=kw["backtest_schemes"], n_quantiles=5)
    got = res.backtest_table
    assert "backtest" in res.stage_seconds and res.audit.ok()
    assert list(got.columns) == list(want.columns) and len(got) == len(want) == 36
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if want[c].dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-13, equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)
    assert np.isfinite(got["spread"].to_numpy(float)).any()


def test_artifacts_without_matplotlib(jax_run, tmp_path, monkeypatch):
    """Where matplotlib does not import, a run that draws the figure into
    ``output_dir`` raises ImportError, as the reference's does; with
    ``make_figure=False`` it writes every other artifact, the scenario csv
    too (research_report.tex, which includes the figure, is skipped)."""
    from fm_returnprediction_tpu_torch import pipeline as port_pipeline

    def no_matplotlib(frames):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(port_pipeline, "draw_figure_1", no_matplotlib)
    base, daily = prepared_from_numpy(jax_run["base"], jax_run["daily"])
    kw = dict(device="cpu", dtype=torch.float64, make_deciles=False, make_specgrid=True,
              specgrid_sink="summary")
    with pytest.raises(ImportError, match="matplotlib"):
        run_pipeline(dense_base=base, compact_daily=daily, output_dir=tmp_path / "figure", **kw)
    run_pipeline(dense_base=base, compact_daily=daily, make_figure=False, output_dir=tmp_path / "out", **kw)
    made = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert made == ["data_saved.marker", "serving_state.npz", "specgrid_scenarios.csv",
                    "table_1.pkl", "table_1.tex", "table_2.pkl", "table_2.tex"]


def test_stage_times_are_recorded(port_run):
    assert {"build_panel", "factors/daily_kernels", "factors/characteristics_winsorize",
            "subset_masks", "table_1", "table_2", "figure_cs", "figure_1",
            "decile_table", "serving_state"} <= set(port_run.stage_seconds)


# -- guards ---------------------------------------------------------------


def test_port_runs_with_jax_blocked(tmp_path):
    """The port's whole path on the CPU in a process where importing jax or
    the JAX package raises: from prepared inputs, from a synthetic universe
    with the guard and the drift sentinel armed, through the command line
    with artifacts, from a raw directory by the columnar route, cold
    (the slot is written) and warm (the slot is mapped), with stage
    checkpoints, the spec-grid scenario sweep, in process and through
    the command line, the bootstrap-SE table in process and through the
    command line, the stacked-QR route through ``FMRP_SPECGRID_ROUTE``, one
    serving-state month ingest, the rolling-origin backtest in process
    and through the command line (``backtest.csv`` written), and the
    estimator family: one sweep of each of fwl, iv, absorb and pooled, one
    bank ``estimator_query``, and ``--specgrid-estimator`` through the
    command line; the telemetry layer: a traced ``run_pipeline`` (both
    trace files written) and ``--trace-dir`` through the command line;
    one ``ERService(device="cpu")`` query; and the fleet and the
    registry: a journaled ``ServingFleet(device="cpu")`` of 2 with one kill
    and replace, ``ServingFleet.recover`` after a hard crash,
    ``--registry-dir --fleet-size 2`` through the command line, and
    ``python -m fm_returnprediction_tpu_torch.registry ls``; the
    processes the port spawns: a spec grid over 2 worker processes and a
    process fleet of 2 with one replica SIGKILLed and replaced; and the
    device mesh: ``run_pipeline(use_mesh=True)`` on 4 virtual CPU devices
    (daily strips, Table 2 by distributed TSQR and the bootstrap table
    sharded; at float64 Table 2 equal to the one-device run's); and
    ``python -m fm_returnprediction_tpu_torch.taskgraph --synthetic`` on
    the CPU twice (the DAG, then its up-to-date rerun) and a
    ``TopologySpec`` journal-mark round trip; the dense daily route
    (``build_daily_panel``, ``daily_characteristics_chunked`` in strips),
    ``run_spec_grid_on_panel``, ``dryrun_multichip(4)`` and ``entry()``,
    the package exports and the doit shim's creators. The
    children inherit a ``PYTHONPATH`` whose first entry holds ``jax``,
    ``jaxlib`` and ``fm_returnprediction_tpu`` packages that raise on
    import, and run from a directory outside the repo, so a child that
    imported either would fail the run."""
    code = textwrap.dedent("""
        import runpy
        import sys

        BLOCKED = ("jax", "jaxlib", "fm_returnprediction_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs
        from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig
        from fm_returnprediction_tpu_torch.pipeline import run_pipeline

        base, daily = make_smoke_inputs(n_firms=80, n_months=60, dtype=np.float64)
        res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64)
        assert res.table_2.shape == (27, 9), res.table_2.shape
        assert res.table_1.shape == (15, 9), res.table_1.shape
        assert res.decile_table.shape == (13, 3), res.decile_table.shape
        assert set(res.figure_1) == {"All stocks", "Large stocks"}
        assert res.serving_state.coef.shape == (60, 6), res.serving_state.coef.shape

        tmp = sys.argv[1]
        res = run_pipeline(synthetic=True, synthetic_config=SyntheticConfig(
            n_firms=60, n_months=72), device="cpu", guard=True,
            audit_dir=tmp + "/audit")
        assert res.audit.as_dict()["violations"] == [], res.audit.report()
        assert "guard_panel_contracts" in res.stage_seconds
        assert "guard_drift" in res.stage_seconds

        sys.argv = ["pipeline", "--synthetic", "--firms", "60", "--months", "72",
                    "--device", "cpu", "--output-dir", tmp + "/out",
                    "--audit-dir", tmp + "/audit_cli"]
        runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__")
        import os
        made = set(os.listdir(tmp + "/out"))
        assert {"data_saved.marker", "table_1.pkl", "table_2.pkl", "serving_state.npz",
                "research_report.tex"} <= made, made
        assert os.listdir(tmp + "/audit_cli") == ["audit.json"]

        from fm_returnprediction_tpu_torch.data.synthetic import write_synthetic_cache
        write_synthetic_cache(tmp + "/raw", SyntheticConfig(n_firms=50, n_months=72))
        runs = [run_pipeline(raw_data_dir=tmp + "/raw", device="cpu", dtype=torch.float64,
                             checkpoint_dir=tmp + "/ckpt") for _ in range(2)]
        cold, warm = (r.timer for r in runs)
        assert "panel/monthly_ingest" in cold.durations, cold.durations
        assert "build_panel/save_prepared" in cold.durations, cold.durations
        assert warm.skipped == {"load_raw_data": "prepared checkpoint hit"}, warm.skipped
        assert "panel/monthly_ingest" not in warm.durations, warm.durations
        assert sorted(os.listdir(tmp + "/ckpt")) == [
            "decile_table.pkl", "manifest.json", "serving_state.npz", "table_1.pkl",
            "table_2.pkl"]
        assert runs[0].table_2.equals(runs[1].table_2)

        res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64,
                           make_specgrid=True)
        frame = res.specgrid_scenarios
        assert frame["cell"].nunique() == 27 and frame["coef"].notna().any(), frame
        sys.argv = ["pipeline", "--synthetic", "--firms", "60", "--months", "72",
                    "--device", "cpu", "--specgrid", "--specgrid-cells", "40",
                    "--specgrid-sink", "topk", "--output-dir", tmp + "/out_sg"]
        runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__")
        import pandas as pd
        top = pd.read_csv(tmp + "/out_sg/specgrid_scenarios.csv")
        assert len(top) == 100 and "draw" in top.columns, top.shape

        res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64,
                           make_bootstrap=True, bootstrap_replicates=50)
        boot = res.bootstrap_table
        assert boot.shape == (24, 12) and "bootstrap_table" in res.stage_seconds, boot.shape
        sys.argv = ["pipeline", "--synthetic", "--firms", "60", "--months", "72",
                    "--device", "cpu", "--bootstrap", "20", "--output-dir", tmp + "/out_bs"]
        runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__")
        assert pd.read_pickle(tmp + "/out_bs/bootstrap_se.pkl").shape == (24, 12)
        assert os.path.exists(tmp + "/out_bs/bootstrap_se.tex")

        os.environ["FMRP_SPECGRID_ROUTE"] = "stacked"
        os.environ["FMRP_FUSE_SUBSETS_MB"] = "0"
        stacked = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64,
                               make_serving=False)
        del os.environ["FMRP_SPECGRID_ROUTE"], os.environ["FMRP_FUSE_SUBSETS_MB"]
        assert stacked.table_2.shape == (27, 9) and set(stacked.sweep) == set(res.sweep)

        from fm_returnprediction_tpu_torch.serving.ingest import ingest_month
        state = res.serving_state
        grown = ingest_month(state, np.zeros(5), np.ones((5, state.n_predictors)),
                             np.ones(5, bool), state.months[-1] + np.timedelta64(31, "D"),
                             device="cpu")
        assert grown.n_months == state.n_months + 1, grown.n_months

        res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64,
                           make_figure=False, make_backtest=True,
                           backtest_schemes="expanding,rolling24")
        assert res.backtest_table.shape[0] == 36 and "backtest" in res.stage_seconds
        assert not res.audit.quarantined, res.audit.report()
        sys.argv = ["pipeline", "--synthetic", "--firms", "60", "--months", "72",
                    "--device", "cpu", "--backtest", "--backtest-sink", "metrics",
                    "--output-dir", tmp + "/out_bt"]
        runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__")
        metrics = pd.read_csv(tmp + "/out_bt/backtest.csv")
        assert len(metrics) == 4 and "spread_tstat_mean" in metrics.columns, metrics.shape

        from fm_returnprediction_tpu_torch.specgrid import grambank
        from fm_returnprediction_tpu_torch.specgrid.scenarios import (
            bank_for_scenarios, run_scenarios)
        panel, masks, factors = res.panel, res.subset_masks, res.factors_dict
        fe = {"ind": np.random.default_rng(2016).integers(0, 12, panel.values.shape[:2])}
        for spec in ("fwl:log_size", "iv:log_bm~log_issues_36", "absorb:ind",
                     "pooled:cluster_twoway"):
            est = run_scenarios(panel, masks, factors, estimators=(spec,), fe_codes=fe)
            assert est["estimator"].nunique() == 1 and est["coef"].notna().any(), spec
        bank = bank_for_scenarios(panel, masks, factors, device="cpu")
        served, disc = grambank.estimator_query(bank, "pooled:cluster_month", device="cpu")
        assert disc["kind"] == "pooled" and np.isfinite(served.coef).any()
        sys.argv = ["pipeline", "--synthetic", "--firms", "60", "--months", "72",
                    "--device", "cpu", "--specgrid-estimator", "fwl:log_size"]
        runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__")
        res = run_pipeline(dense_base=base, compact_daily=daily, device="cpu", dtype=torch.float64,
                           make_figure=False, trace_dir=tmp + "/trace")
        assert sorted(os.listdir(tmp + "/trace")) == ["events.jsonl", "trace.json"]
        sys.argv = ["pipeline", "--synthetic", "--firms", "60", "--months", "72",
                    "--device", "cpu", "--trace-dir", tmp + "/trace_cli"]
        runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__")
        import json
        names = {json.loads(line).get("name") for line in open(tmp + "/trace_cli/events.jsonl")}
        assert {"run_pipeline", "table_2", "serving_state"} <= names, names
        from fm_returnprediction_tpu_torch.serving import (
            ERService, build_serving_state_from_panel)
        state = build_serving_state_from_panel(res.panel, res.subset_masks["All stocks"],
                                               window=24, min_periods=12)
        with ERService(state, max_batch=8, device="cpu") as svc:
            quote = svc.query(state.n_months - 1, np.zeros(state.n_predictors))
        assert np.isfinite(quote), quote
        from fm_returnprediction_tpu_torch.serving import ServingFleet, replay_journal
        months = [state.n_months - 1] * 16
        rows = np.zeros((16, state.n_predictors))
        fleet = ServingFleet(state, 2, max_batch=8, journal=tmp + "/fleet.jsonl",
                             device="cpu")
        before = fleet.query_many(months, rows)
        fleet.kill_replica("r0", reason="test")
        actions = fleet.supervisor.tick()
        assert actions == ["failover:r0->r2"], actions
        assert np.array_equal(fleet.query_many(months, rows), before)
        fleet.drain()
        fleet.hard_crash()
        fleet, report = ServingFleet.recover(tmp + "/fleet.jsonl", state=state,
                                             max_batch=8, device="cpu")
        assert report.clean and report.n_replicas == 2, report
        assert np.array_equal(fleet.query_many(months, rows), before)
        fleet.close()
        assert replay_journal(tmp + "/fleet.jsonl").clean
        sys.argv = ["pipeline", "--synthetic", "--firms", "60", "--months", "150",
                    "--device", "cpu", "--registry-dir", tmp + "/reg", "--fleet-size", "2"]
        import contextlib, io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_module("fm_returnprediction_tpu_torch.pipeline", run_name="__main__")
        line = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("serving fleet smoke: ")][-1]
        smoke = json.loads(line.split(": ", 1)[1])
        assert smoke["finite_quotes"] == smoke["n_queries"] == 256, smoke
        assert smoke["healthy_replicas"] == 2, smoke
        from fm_returnprediction_tpu_torch.registry.__main__ import main as registry_main
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert registry_main(["--registry-dir", tmp + "/reg", "ls"]) == 0
        assert "artifacts/serving_state/" in buf.getvalue(), buf.getvalue()
        import signal, time
        from fm_returnprediction_tpu_torch.specgrid import Spec, SpecGrid, multiproc
        from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid
        gy = torch.randn(24, 41, dtype=torch.float64)
        gx = torch.randn(24, 41, 3, dtype=torch.float64)
        gmasks = {"all": torch.rand(24, 41) > 0.2}
        grid = SpecGrid((Spec("m", ("c0", "c1", "c2"), "all"),), union=("c0", "c1", "c2"))
        one = run_spec_grid(gy, gx, gmasks, grid)
        two = run_spec_grid(gy, gx, gmasks, grid, procs=2)
        assert {r["device"] for r in multiproc.cached_pool().last_reports} == {"cpu"}
        multiproc._close_cached_pool()
        assert np.allclose(one.coef, two.coef, rtol=1e-12, atol=1e-12), (one.coef, two.coef)
        fleet = ServingFleet(state, 2, max_batch=8, journal=tmp + "/proc.jsonl",
                             replica_mode="process", device="cpu")
        assert np.array_equal(fleet.query_many(months, rows), before)
        victim = fleet.replica("r0").service.proc
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        deadline = time.monotonic() + 60
        while "r0" in fleet.replica_states() and time.monotonic() < deadline:
            fleet.supervisor.tick()
            time.sleep(0.05)
        assert "r0" not in fleet.replica_states() and fleet.stats()["healthy_replicas"] == 2
        assert np.array_equal(fleet.query_many(months, rows), before)
        fleet.close()
        assert replay_journal(tmp + "/proc.jsonl").clean
        import os
        os.environ["FMRP_VIRTUAL_DEVICES"] = "4"
        from fm_returnprediction_tpu_torch.parallel import mesh as mesh_mod
        kw = dict(synthetic=True, synthetic_config=SyntheticConfig(n_firms=60, n_months=72),
                  device="cpu", dtype=torch.float64, make_figure=False, make_deciles=False,
                  make_serving=False)
        meshed = run_pipeline(use_mesh=True, make_bootstrap=True, bootstrap_replicates=16,
                              **kw)
        counts = mesh_mod.collective_counts()
        assert counts[("psum", "boot")] == 9 and counts[("all_gather", "firms")] == 9, counts
        one = run_pipeline(use_mesh=False, **kw)
        assert meshed.table_2.equals(one.table_2), (meshed.table_2, one.table_2)
        del os.environ["FMRP_VIRTUAL_DEVICES"]
        os.environ.update(DATA_DIR=tmp + "/tg_data", OUTPUT_DIR=tmp + "/tg_out")
        sys.argv = ["taskgraph", "--synthetic", "--device", "cpu", "--db", tmp + "/tg.sqlite"]
        for _ in range(2):   # the DAG, then its rerun with every task up to date
            try:
                runpy.run_module("fm_returnprediction_tpu_torch.taskgraph", run_name="__main__")
            except SystemExit as exc:
                assert exc.code == 0, exc.code
        assert {"table_2.pkl", "specgrid_scenarios.csv", "backtest.csv"} <= set(
            os.listdir(tmp + "/tg_out")), os.listdir(tmp + "/tg_out")
        assert os.path.exists(tmp + "/tg_data/processed/lewellen_panel.npz")
        from fm_returnprediction_tpu_torch.topology import TopologySpec
        spec = TopologySpec(replicas=2, replica_mode="process", transport="shm", grid_procs=2)
        assert TopologySpec.from_mark(json.loads(json.dumps(spec.to_mark()))) == spec
        from fm_returnprediction_tpu_torch.data.synthetic import generate_synthetic_wrds
        from fm_returnprediction_tpu_torch.ops.daily_chunked import (
            daily_characteristics_chunked)
        from fm_returnprediction_tpu_torch.panel.daily import build_daily_panel
        frames = generate_synthetic_wrds(SyntheticConfig(n_firms=20, n_months=30))
        dp = build_daily_panel(frames["crsp_d"], frames["crsp_index_d"],
                               np.sort(frames["crsp_m"]["jdate"].unique()))
        vol, beta = daily_characteristics_chunked(
            dp.ret, dp.mask, dp.mkt, dp.day_month_id, dp.week_id, dp.week_month_id,
            dp.n_months, dp.n_weeks, mkt_present=dp.mkt_present, window=60,
            min_periods=20, window_weeks=26, firm_chunk=8, device="cpu")
        assert vol.shape == beta.shape == (30, 20) and np.isfinite(vol).any()
        from fm_returnprediction_tpu_torch.panel.characteristics import get_factors
        from fm_returnprediction_tpu_torch.panel.transform_compustat import (
            add_report_date, calc_book_equity, expand_compustat_annual_to_monthly,
            merge_CRSP_and_Compustat)
        from fm_returnprediction_tpu_torch.panel.transform_crsp import calculate_market_equity
        merged = merge_CRSP_and_Compustat(
            calculate_market_equity(frames["crsp_m"]),
            expand_compustat_annual_to_monthly(calc_book_equity(add_report_date(
                frames["comp"].copy()))), frames["ccm"])
        fp, _ = get_factors(merged, frames["crsp_d"], frames["crsp_index_d"], np.float64,
                            device="cpu")
        from fm_returnprediction_tpu_torch.pipeline import build_panel
        bp, _ = build_panel(dict(frames), np.float64, None, device="cpu")
        assert torch.isfinite(fp.values).any() and torch.isfinite(bp.values).any()
        from fm_returnprediction_tpu_torch.ops.daily_kernels import weekly_partial_sums
        shuffled = np.random.default_rng(0).permutation(dp.week_id)
        sums = weekly_partial_sums(torch.from_numpy(dp.ret), torch.from_numpy(dp.mask),
                                   torch.from_numpy(dp.mkt), torch.from_numpy(shuffled),
                                   dp.n_weeks)
        assert sums[0].shape == (dp.n_weeks, 20)
        wy = torch.randn(12, 90, dtype=torch.float64)
        wx = torch.randn(12, 90, 40, dtype=torch.float64)
        names = tuple(f"w{i}" for i in range(40))
        wgrid = SpecGrid((Spec("wide", names, "all"),), union=names)
        wide = run_spec_grid(wy, wx, {"all": torch.ones(12, 90, dtype=torch.bool)}, wgrid)
        assert np.isfinite(wide.coef).all() and wide.coef.shape == (1, 40)
        from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth
        assert torch.isfinite(fama_macbeth(wy, wx[..., :3], torch.ones(12, 90, dtype=torch.bool),
                                           guard=False)[1].coef).all()
        from fm_returnprediction_tpu_torch.specgrid import run_spec_grid_on_panel, table2_grid
        grid = table2_grid(res.factors_dict, subsets=list(res.subset_masks))
        on_panel = run_spec_grid_on_panel(res.panel, res.subset_masks, grid)
        assert on_panel.coef.shape[0] == 9 and np.isfinite(on_panel.coef).any()
        from fm_returnprediction_tpu_torch.dryrun import dryrun_multichip, entry
        assert len(dryrun_multichip(4, device="cpu")) == 7
        fn, args = entry(device="cpu")
        assert torch.isfinite(fn(*args)[0]).all()
        import importlib
        for pkg in ("ops", "guard", "resilience", "utils", "models"):
            mod = importlib.import_module("fm_returnprediction_tpu_torch." + pkg)
            assert all(hasattr(mod, n) for n in mod.__all__), pkg
        os.environ["BACKEND"] = "cpu"
        shim = runpy.run_path(os.path.join(os.path.dirname(
            sys.modules["fm_returnprediction_tpu_torch"].__file__), "taskgraph", "dodo.py"))
        assert "task_build_panel" in shim and "task_grid_parity" in shim
        loaded = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not loaded, loaded
        print("PORT-OK")
    """)
    # packages that raise on import, first on the path every child inherits
    shadow = tmp_path / "shadow"
    for name in ("jax", "jaxlib", "fm_returnprediction_tpu"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('blocked import of {name} in a port process')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(shadow), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PORT-OK" in out.stdout


def test_default_device_without_gpu_raises(monkeypatch, jax_run):
    base, daily = prepared_from_numpy(jax_run["base"], jax_run["daily"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(dense_base=base, compact_daily=daily)


def _port_files():
    files = [REPO / "chip_smoke.py"]
    for path in sorted((REPO / "fm_returnprediction_tpu_torch").rglob("*")):
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh"):
            files.append(path)
    return files


@pytest.mark.parametrize("pattern", [r"import\s+jax", r"from\s+jax\b",
                                     r"fm_returnprediction_tpu\."])
def test_port_never_names_jax_or_the_jax_package(pattern):
    files = _port_files()
    assert len(files) > 20
    names = {str(f.relative_to(REPO / "fm_returnprediction_tpu_torch")) for f in files[1:]}
    assert {"guard/checks.py", "guard/contracts.py", "guard/drift.py",
            "resilience/errors.py", "data/synthetic.py", "data/wrds_pull.py",
            "panel/transform_crsp.py", "panel/transform_compustat.py",
            "reporting/latex.py", "pipeline.py", "registry/integrity.py",
            "data/columnar.py", "panel/columnar.py", "data/prepared.py",
            "resilience/faults.py", "resilience/checkpoint.py", "utils/timing.py",
            "utils/cache.py", "specgrid/grams.py", "specgrid/solve.py", "specgrid/specs.py",
            "specgrid/cellspace.py", "specgrid/coreset.py", "specgrid/boot.py",
            "specgrid/sinks.py", "specgrid/engine.py", "specgrid/scenarios.py",
            "specgrid/estimators/core.py", "specgrid/__init__.py", "csrc/gram.cu",
            "ops/ols.py", "ops/fama_macbeth.py", "models/forecast.py", "serving/state.py",
            "serving/ingest.py", "reporting/fusion.py", "reporting/table2.py",
            "reporting/figure1.py", "reporting/bootstrap_table.py", "parallel/__init__.py",
            "parallel/bootstrap.py", "specgrid/grambank.py", "specgrid/estimators/fwl.py",
            "backtest/__init__.py", "backtest/paths.py", "backtest/evaluate.py",
            "backtest/portfolio.py", "backtest/space.py", "backtest/sinks.py",
            "backtest/sweep.py", "ops/newey_west.py", "specgrid/estimators/__init__.py",
            "specgrid/estimators/absorb.py", "specgrid/estimators/cluster.py",
            "specgrid/estimators/grid.py", "specgrid/estimators/iv.py",
            "specgrid/estimators/stream.py", "telemetry/__init__.py", "telemetry/identity.py",
            "telemetry/spans.py", "telemetry/metrics.py", "telemetry/export.py",
            "telemetry/perf.py", "telemetry/slo.py", "telemetry/regress.py",
            "resilience/retry.py", "serving/executor.py", "serving/batcher.py",
            "serving/service.py", "serving/__init__.py", "registry/__init__.py",
            "registry/__main__.py", "registry/store.py", "registry/artifacts.py",
            "registry/executables.py", "registry/warm.py", "serving/journal.py",
            "serving/recovery.py", "serving/brownout.py", "serving/supervisor.py",
            "serving/fleet.py", "serving/loadgen.py", "telemetry/distributed.py",
            "cuda_build.py", "parallel/distributed.py", "parallel/shm.py",
            "specgrid/multiproc.py", "specgrid/mp_worker.py", "serving/shm.py",
            "serving/replica_worker.py", "serving/replica_proc.py",
            "telemetry/timeline.py", "parallel/mesh.py", "parallel/partition.py",
            "parallel/fm_sharded.py", "parallel/daily_sharded.py",
            "parallel/time_sharded.py", "parallel/multihost.py",
            "specgrid/sharded.py", "settings.py", "utils/frames.py", "utils/figures.py",
            "reporting/published.py", "data/benchscale.py", "taskgraph/__init__.py",
            "taskgraph/__main__.py", "taskgraph/engine.py", "taskgraph/tasks.py",
            "taskgraph/docs_site.py", "topology/__init__.py", "topology/spec.py",
            "topology/controller.py", "dryrun.py", "taskgraph/dodo.py", "panel/daily.py",
            "panel/dense.py", "panel/subsets.py", "ops/daily_chunked.py", "ops/__init__.py",
            "guard/__init__.py", "resilience/__init__.py", "utils/__init__.py",
            "models/__init__.py", "models/lewellen.py"} <= names
    hits = [str(f.relative_to(REPO)) for f in files
            if re.search(pattern, f.read_text())]
    assert not hits, hits
