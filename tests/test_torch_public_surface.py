"""The package boundary of the port and its small public helpers, vs the
JAX package.

- each package's ``__all__`` (``ops``, ``guard``, ``resilience``,
  ``utils``, ``models``: the JAX package's list in its order; ``serving``
  and ``specgrid``: every JAX name but the JAX-only trace counter) and
  every name in it resolves; importing the packages builds and loads no
  kernel library;
- ``panel.dense.dense_to_long``, ``panel.subsets.
  flag_firms_missing_variables``, ``models.lewellen.model_by_name``,
  ``SpecGrid.universe_names``, ``utils.timing.stage`` and
  ``StageTimer.dump``, ``CostLedger.stats``: equal to the JAX functions'
  results on the same inputs; ``telemetry.perf.provenance_summary`` on a
  ledger of builds, fetches and captures;
- ``specgrid.run_spec_grid_on_panel`` at float64 on the CPU: against the
  JAX function at rtol 1e-8 (atol 1e-13), with counts and the referee's
  specs equal, and bit for bit against the port's ``run_spec_grid`` on the
  same tensors.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.models import lewellen as jax_lewellen
from fm_returnprediction_tpu.panel import dense as jax_dense
from fm_returnprediction_tpu.panel import subsets as jax_subsets
from fm_returnprediction_tpu.specgrid import Spec as JaxSpec
from fm_returnprediction_tpu.specgrid import SpecGrid as JaxSpecGrid
from fm_returnprediction_tpu.specgrid import run_spec_grid_on_panel as jax_on_panel
from fm_returnprediction_tpu.telemetry import perf as jax_perf
from fm_returnprediction_tpu.utils import timing as jax_timing
from fm_returnprediction_tpu_torch.models import lewellen
from fm_returnprediction_tpu_torch.panel import dense, subsets
from fm_returnprediction_tpu_torch.specgrid import Spec, SpecGrid, run_spec_grid
from fm_returnprediction_tpu_torch.specgrid import run_spec_grid_on_panel
from fm_returnprediction_tpu_torch.telemetry import perf
from fm_returnprediction_tpu_torch.utils import timing

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
SAME_ORDER = ("ops", "guard", "resilience", "utils", "models")
JAX_ONLY = {"program_trace_counts"}  # a jit trace counter (test_torch_surface.ALLOWED)


@pytest.mark.parametrize("pkg", SAME_ORDER + ("serving", "specgrid"))
def test_package_exports_resolve(pkg):
    port = importlib.import_module(f"fm_returnprediction_tpu_torch.{pkg}")
    ref = importlib.import_module(f"fm_returnprediction_tpu.{pkg}")
    if pkg in SAME_ORDER:
        assert list(port.__all__) == list(ref.__all__)
    else:
        assert set(ref.__all__) - JAX_ONLY <= set(port.__all__), (
            sorted(set(ref.__all__) - JAX_ONLY - set(port.__all__)))
    unresolved = [n for n in port.__all__ if not hasattr(port, n)]
    assert not unresolved, unresolved
    assert len(set(port.__all__)) == len(port.__all__)


def test_importing_the_packages_builds_no_kernel(tmp_path):
    code = (
        "import importlib, os\n"
        "for pkg in ('ops', 'guard', 'resilience', 'utils', 'models', 'serving', 'specgrid',"
        " 'parallel', 'telemetry', 'registry', 'taskgraph'):\n"
        "    importlib.import_module('fm_returnprediction_tpu_torch.' + pkg)\n"
        "from fm_returnprediction_tpu_torch import cuda_build\n"
        "assert cuda_build.NVCC_RUNS == 0 and not cuda_build._LIBS, cuda_build._LIBS\n"
        "assert not os.path.exists(os.environ['FMRP_CUDA_BUILD_DIR'])\n"
        "print('IMPORT-OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), FMRP_CUDA_BUILD_DIR=str(tmp_path / "build"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORT-OK" in out.stdout


@pytest.fixture(scope="module")
def long_frame():
    rng = np.random.default_rng(11)
    rows = []
    for month in pd.date_range("2000-01-31", periods=8, freq="ME"):
        for firm in rng.choice(np.arange(100, 120), size=12, replace=False):
            rows.append((month, firm, *rng.standard_normal(4)))
    frame = pd.DataFrame(rows, columns=["date", "permno", "retx", "log_size", "log_bm",
                                        "return_12_2"])
    # firm 100 never has log_bm: flagged by the Table 1 filter
    frame.loc[frame["permno"] == 100, "log_bm"] = np.nan
    return frame


def _panels(frame):
    cols = ["retx", "log_size", "log_bm", "return_12_2"]
    return (dense.long_to_dense(frame, "date", "permno", cols),
            jax_dense.long_to_dense(frame, "date", "permno", cols))


@pytest.mark.parametrize("on_tensor", [False, True])
def test_dense_to_long_matches_reference(long_frame, on_tensor):
    port, ref = _panels(long_frame)
    if on_tensor:
        port.values = torch.from_numpy(port.values)
    got, want = dense.dense_to_long(port), jax_dense.dense_to_long(ref)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == len(long_frame)


@pytest.mark.parametrize("needed", [None, ("retx", "log_size")])
def test_flag_firms_missing_variables_matches_reference(long_frame, needed):
    port, ref = _panels(long_frame)
    kw = {} if needed is None else {"needed_vars": needed}
    got = subsets.flag_firms_missing_variables(port, **kw)
    assert got == jax_subsets.flag_firms_missing_variables(ref, **kw)
    assert (100 in got) == (needed is None)
    port.values = torch.from_numpy(port.values)
    assert subsets.flag_firms_missing_variables(port, **kw) == got


def test_model_by_name_matches_reference():
    for model in jax_lewellen.MODELS:
        got = lewellen.model_by_name(model.name)
        assert (got.name, list(got.predictors)) == (model.name, list(model.predictors))
    with pytest.raises(KeyError):
        lewellen.model_by_name("Model 9")


def test_universe_names_match_reference():
    specs = [("a", ("x", "y"), "Large stocks"), ("b", ("x",), "All stocks"),
             ("c", ("y",), "Large stocks")]
    got = SpecGrid(tuple(Spec(*s) for s in specs)).universe_names
    want = JaxSpecGrid(tuple(JaxSpec(*s) for s in specs)).universe_names
    assert got == want == ["Large stocks", "All stocks"]


def test_stage_and_dump_match_reference(tmp_path):
    with timing.stage("surface_probe"):
        pass
    assert "surface_probe" in timing._GLOBAL_TIMER.durations
    mine = timing.StageTimer("cpu")
    with timing.stage("outer", timer=mine):
        with timing.stage("outer/inner", timer=mine):
            pass
    ref = jax_timing.StageTimer()
    ref.durations.update(mine.durations)
    mine.dump(tmp_path / "port" / "stages.json")
    ref.dump(tmp_path / "ref" / "stages.json")
    assert (tmp_path / "port" / "stages.json").read_text() == (
        tmp_path / "ref" / "stages.json").read_text()
    assert json.loads((tmp_path / "port" / "stages.json").read_text()) == mine.durations


def _record(program, provenance, seconds, saved=None, cls=perf.ProgramRecord):
    return cls(program=program, signature="s", fingerprint="f", backend="cuda", lower_s=0.0,
               compile_s=seconds, flops=None, bytes_accessed=None, temp_bytes=None,
               argument_bytes=None, output_bytes=None, generated_code_bytes=None,
               provenance=provenance, cache_entries_delta=0, saved_s=saved)


def test_cost_ledger_stats_match_reference():
    ledgers = perf.CostLedger(maxlen=2), jax_perf.CostLedger(maxlen=2)
    for ledger, cls in zip(ledgers, (perf.ProgramRecord, jax_perf.ProgramRecord)):
        for i in range(3):
            ledger.add(_record("p", "built", float(i), cls=cls))
    assert ledgers[0].stats() == ledgers[1].stats() == {"records": 2, "dropped": 1}
    for ledger in ledgers:
        ledger.reset()
    assert ledgers[0].stats() == ledgers[1].stats() == {"records": 0, "dropped": 0}


def test_provenance_summary_reads_builds_against_fetches():
    records = [_record("cuda_kernel", "built", 12.0), _record("cuda_kernel", "fetched", 0.5, 12.0),
               _record("cuda_kernel", "fetched", 0.25, None),
               _record("serving_bucket", "captured", 0.125)]
    got = perf.provenance_summary(records)
    assert got["cuda_kernel"] == {"built": 1, "fetched": 2, "captured": 0, "eager": 0,
                                  "build_s": 12.0, "fetch_s": 0.75, "saved_s": 12.0}
    assert got["serving_bucket"]["captured"] == 1
    assert got["serving_bucket"]["build_s"] == 0.125
    ledger = perf.cost_ledger()
    before = ledger.last_seq
    perf.record_program("surface_probe", "sig", 0.5, backend="cpu", provenance="eager")
    window = ledger.since(before)
    assert perf.provenance_summary(window) == {"surface_probe": {
        "built": 0, "fetched": 0, "captured": 0, "eager": 1,
        "build_s": 0.5, "fetch_s": 0.0, "saved_s": 0.0}}


@pytest.fixture(scope="module")
def grid_panel():
    rng = np.random.default_rng(17)
    t, n = 40, 60
    names = ["retx", "c0", "c1", "c2", "c3"]
    values = rng.standard_normal((t, n, len(names)))
    values[..., 0] = values[..., 1:].sum(-1) * 0.1 + 0.5 * values[..., 0]
    mask = rng.random((t, n)) > 0.15
    values[~mask] = np.nan
    values[rng.random(values.shape) < 0.02] = np.nan
    months = pd.date_range("2001-01-31", periods=t, freq="ME").values
    masks = {"all": mask, "big": mask & (rng.random((t, n)) > 0.4),
             "unused": np.zeros((t, n), bool)}
    specs = [("m1", ("c0", "c1"), "all"), ("m2", ("c0", "c1", "c2", "c3"), "big"),
             ("m3", ("c2",), "all")]
    return values, mask, months, np.arange(n), names, masks, specs


def test_run_spec_grid_on_panel_matches_reference(grid_panel):
    values, mask, months, ids, names, masks, specs = grid_panel
    grid = SpecGrid(tuple(Spec(*s) for s in specs))
    port_panel = dense.DensePanel(values=values.copy(), mask=mask, months=months, ids=ids,
                                  var_names=names)
    got = run_spec_grid_on_panel(port_panel, {k: torch.from_numpy(m) for k, m in masks.items()},
                                 grid, device="cpu")
    ref_panel = jax_dense.DensePanel(values=values.copy(), mask=mask, months=months, ids=ids,
                                     var_names=names)
    want = jax_on_panel(ref_panel, {k: jnp.asarray(m) for k, m in masks.items()},
                        JaxSpecGrid(tuple(JaxSpec(*s) for s in specs)))
    for field in ("slopes", "intercept", "r2", "coef", "tstat", "nw_se", "mean_r2", "mean_n"):
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(want, field)),
                                   rtol=1e-8, atol=1e-13, equal_nan=True, err_msg=field)
    for field in ("n_obs", "month_valid", "n_months", "suspect_months"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))
    assert tuple(got.referee_specs) == tuple(want.referee_specs)
    assert np.isfinite(got.coef).any()

    # the same tensors through run_spec_grid: bit for bit; the panel's values
    # already on the device stay there
    y = torch.from_numpy(values[..., 0].copy())
    x = torch.from_numpy(values[..., 1:].copy())
    same = run_spec_grid(y, x, {k: torch.from_numpy(masks[k]) for k in ("all", "big")}, grid)
    port_panel.values = torch.from_numpy(values.copy())
    again = run_spec_grid_on_panel(port_panel, {k: torch.from_numpy(m)
                                                for k, m in masks.items()}, grid)
    for a, b, c in zip(got, same, again):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
