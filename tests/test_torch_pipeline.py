"""The port's slice as a whole vs the JAX package's, and the port's guards.

The JAX package builds the prepared inputs (``build_panel`` with
``capture``) from its synthetic universe; the same dense base panel and
compact daily strips then go through the JAX warm path
(``build_panel_prepared`` → ``compute_subset_masks`` → ``build_table_2``)
and through the port's ``run_pipeline(device="cpu", dtype=torch.float64)``.
Enriched panel values agree at rtol 1e-10 with identical NaN patterns, the
masks exactly, Table 2's per-cell numbers at rtol 1e-8, and the formatted
frames are equal.
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
from fm_returnprediction_tpu.reporting.table2 import build_table_2
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
    return dict(base=base, daily=daily, panel=panel, factors=factors,
                masks=masks, table=table, cells=cells)


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


def test_stage_times_are_recorded(port_run):
    assert {"build_panel", "daily_kernels", "characteristics_winsorize",
            "subset_masks", "table_2"} <= set(port_run.stage_seconds)


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
