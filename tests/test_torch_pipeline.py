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
``build_serving_state_from_panel``) run on the same JAX panel: Table 1 at
rtol 1e-10 with N exact, the figure frames, decile table and serving state
at rtol 1e-8 with counts and flags exact.
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
    return run_pipeline(base, daily, device="cpu", dtype=torch.float64)


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
    res = run_pipeline(base, daily, device="cpu", dtype=torch.float64,
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


def test_stage_times_are_recorded(port_run):
    assert {"build_panel", "daily_kernels", "characteristics_winsorize",
            "subset_masks", "table_1", "table_2", "figure_cs", "figure_1",
            "decile_table", "serving_state"} <= set(port_run.stage_seconds)


# -- guards ---------------------------------------------------------------


def test_port_runs_with_jax_blocked():
    """The port's whole path on the CPU in a process where importing jax or
    the JAX package raises."""
    code = textwrap.dedent("""
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
        from fm_returnprediction_tpu_torch.pipeline import run_pipeline

        base, daily = make_smoke_inputs(n_firms=80, n_months=60, dtype=np.float64)
        res = run_pipeline(base, daily, device="cpu", dtype=torch.float64)
        assert res.table_2.shape == (27, 9), res.table_2.shape
        assert res.table_1.shape == (15, 9), res.table_1.shape
        assert res.decile_table.shape == (13, 3), res.decile_table.shape
        assert set(res.figure_1) == {"All stocks", "Large stocks"}
        assert res.serving_state.coef.shape == (60, 6), res.serving_state.coef.shape
        loaded = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not loaded, loaded
        print("PORT-OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PORT-OK" in out.stdout


def test_default_device_without_gpu_raises(monkeypatch, jax_run):
    base, daily = prepared_from_numpy(jax_run["base"], jax_run["daily"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(base, daily)


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
    hits = [str(f.relative_to(REPO)) for f in files
            if re.search(pattern, f.read_text())]
    assert not hits, hits
