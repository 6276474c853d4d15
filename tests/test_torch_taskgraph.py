"""The port's task graph against ``tests/test_taskgraph.py``'s nineteen
cases, and ``tests/test_multiprocess.py``'s two-process DAG.

The engine cases run the port's ``TaskRunner`` as the reference tests run
theirs. The synthetic DAG runs in both packages on the same synthetic
universe in float64 (the port on the CPU); its Table 1, Table 2, decile
table, serving state, scenario sweep and backtest are held against the JAX
DAG's at the tolerances of ``tests/test_torch_pipeline.py``, and a rerun
finds every task up to date. The panel checkpoint is read across packages
both ways, the command line runs in a subprocess, the WRDS route of
``pull_data`` runs against a stand-in ``wrds`` module, and the notebook
tasks run on a notebook this file writes."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from fm_returnprediction_tpu_torch.taskgraph.engine import (
    PlainReporter,
    Task,
    TaskRunner,
    default_reporter,
    process_route,
    write_timing_log,
)

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def tmp_runner(tmp_path):
    def make(tasks):
        return TaskRunner(tasks, db_path=tmp_path / "state.sqlite", reporter=PlainReporter())

    return make


# -- the engine ----------------------------------------------------------------


def test_runs_then_skips_then_reruns_on_change(tmp_path, tmp_runner):
    src = tmp_path / "in.txt"
    dst = tmp_path / "out.txt"
    src.write_text("v1")
    runs = []

    def build():
        runs.append(1)
        dst.write_text(src.read_text().upper())

    task = Task("build", [build], file_dep=[src], targets=[dst])
    with tmp_runner([task]) as r:
        assert r.run() and len(runs) == 1
        assert r.run() and len(runs) == 1          # content unchanged → skip
        dst.unlink()
        assert r.run() and len(runs) == 2          # missing target → rerun
        src.write_text("v2")
        assert r.run() and len(runs) == 3          # content changed → rerun
        assert dst.read_text() == "V2"
        os.utime(src, ns=(1, 1))                   # metadata drift, same bytes
        assert r.run() and len(runs) == 3


def test_state_survives_process_boundary(tmp_path):
    src = tmp_path / "in.txt"
    dst = tmp_path / "out.txt"
    src.write_text("x")
    task = Task("t", [lambda: dst.write_text("y")], file_dep=[src], targets=[dst])
    db = tmp_path / "db.sqlite"
    with TaskRunner([task], db_path=db, reporter=PlainReporter()) as r1:
        r1.run()
    with TaskRunner([task], db_path=db, reporter=PlainReporter()) as r2:
        assert r2.is_up_to_date(task)
        r2.forget(["t"])
        assert not r2.is_up_to_date(task)


def test_task_dep_ordering_and_cycle(tmp_runner):
    order = []
    tasks = [
        Task("c", [lambda: order.append("c")], task_dep=["b"]),
        Task("b", [lambda: order.append("b")], task_dep=["a"]),
        Task("a", [lambda: order.append("a")]),
    ]
    with tmp_runner(tasks) as r:
        assert r.run(["c"])
        assert order == ["a", "b", "c"]
    cyc = [Task("x", [], task_dep=["y"]), Task("y", [], task_dep=["x"])]
    with tmp_runner(cyc) as r:
        with pytest.raises(ValueError, match="cycle"):
            r.run()
    with tmp_runner(cyc) as r:
        with pytest.raises(KeyError, match="Unknown task"):
            r.run(["nope"])


def test_failure_halts_and_is_not_up_to_date(tmp_runner):
    def boom():
        raise RuntimeError("nope")

    done = []
    tasks = [Task("bad", [boom]), Task("after", [lambda: done.append(1)], task_dep=["bad"])]
    with tmp_runner(tasks) as r:
        assert not r.run(["after"])
        assert done == []
        assert not r.is_up_to_date(tasks[0])


def test_shell_action(tmp_path, tmp_runner):
    out = tmp_path / "shell.txt"
    task = Task("sh", [f"echo hello > {out}"], targets=[out])
    with tmp_runner([task]) as r:
        assert r.run()
        assert out.read_text().strip() == "hello"
    slow = Task("slow_sh", ["sleep 5"], timeout_s=0.2)
    with tmp_runner([slow]) as r:
        assert not r.run()
        assert "TaskTimeoutError" in r.failures()[-1]["error"]


def test_duplicate_task_name_rejected(tmp_path):
    with pytest.raises(ValueError, match="Duplicate"):
        TaskRunner([Task("a", []), Task("a", [])], db_path=tmp_path / "d.sqlite")


def test_slurm_selects_plain_reporter(monkeypatch):
    monkeypatch.setenv("SLURM_JOB_ID", "12345")
    assert type(default_reporter()) is PlainReporter
    monkeypatch.delenv("SLURM_JOB_ID")
    assert type(default_reporter()) is not PlainReporter


def test_timing_log(tmp_path, tmp_runner):
    task = Task("quick", [lambda: None], targets=[])
    with tmp_runner([task]) as r:
        r.run()
        log = tmp_path / "timings.json"
        write_timing_log(r, log)
        assert "quick" in json.load(open(log))


def test_failure_preserves_last_success_timing(tmp_path):
    src = tmp_path / "in.txt"
    src.write_text("a")
    state = {"fail": False}

    def action():
        if state["fail"]:
            raise RuntimeError("boom")

    task = Task("t", [action], file_dep=[src])
    with TaskRunner([task], db_path=tmp_path / "db.sqlite", reporter=PlainReporter()) as r:
        assert r.run()
        first = r.timings()["t"]
        state["fail"] = True
        src.write_text("b")
        assert not r.run()
        assert r.timings()["t"] == first
        assert not r.is_up_to_date(task)


def test_keep_going_runs_disjoint_subgraphs_and_skips_dependents(tmp_runner):
    ran = []

    def boom():
        raise RuntimeError("nope")

    tasks = [
        Task("bad", [boom]),
        Task("child", [lambda: ran.append("child")], task_dep=["bad"]),
        Task("grandchild", [lambda: ran.append("gc")], task_dep=["child"]),
        Task("island", [lambda: ran.append("island")]),
    ]
    with tmp_runner(tasks) as r:
        assert not r.run(keep_going=True)
        assert ran == ["island"]
        failures = {f["task"]: f["error"] for f in r.failures()}
        assert "nope" in failures["bad"]
        assert "dependency 'bad' failed" in failures["child"]
        assert "dependency 'child' failed" in failures["grandchild"]
        assert "island" not in failures


def test_task_retry_exhausts_then_fails_and_succeeds_within_budget(tmp_runner):
    calls = {"n": 0}

    def flaky_until(k):
        def action():
            calls["n"] += 1
            if calls["n"] < k:
                raise OSError("transient")
        return action

    always = Task("t", [flaky_until(99)], retries=2, retry_backoff_s=0.0)
    with tmp_runner([always]) as r:
        assert not r.run()
        assert calls["n"] == 3
        assert "after 3 attempts" in r.failures()[-1]["error"]
        assert not r.is_up_to_date(always)
    calls["n"] = 0
    heals = Task("t2", [flaky_until(3)], retries=2, retry_backoff_s=0.0)
    with tmp_runner([heals]) as r:
        assert r.run()
        assert calls["n"] == 3
        assert not [f for f in r.failures() if f["task"] == "t2"]


def test_task_timeout_kills_sleeping_action(tmp_runner):
    t0 = time.perf_counter()
    task = Task("sleepy", [lambda: time.sleep(30)], timeout_s=0.2)
    with tmp_runner([task]) as r:
        assert not r.run()
        assert time.perf_counter() - t0 < 5
        assert "exceeded 0.2s" in r.failures()[-1]["error"]


def test_forget_after_failure_reruns_cleanly(tmp_runner):
    state = {"fail": True}

    def action():
        if state["fail"]:
            raise RuntimeError("boom")

    task = Task("t", [action])
    with tmp_runner([task]) as r:
        assert not r.run()
        assert len(r.failures()) == 1
        r.forget(["t"])
        assert r.failures() == []
        state["fail"] = False
        assert r.run()
        assert not r.is_up_to_date(task)   # a bare task is always stale


def test_keyboard_interrupt_records_failure_and_closes_db(tmp_path):
    import sqlite3 as _sqlite3

    failed = []

    class Spy(PlainReporter):
        def fail(self, task, err):
            failed.append((task.name, err))

    def interrupt():
        raise KeyboardInterrupt

    db = tmp_path / "db.sqlite"
    r = TaskRunner([Task("t", [interrupt])], db_path=db, reporter=Spy())
    with pytest.raises(KeyboardInterrupt):
        r.run()
    assert failed and isinstance(failed[0][1], KeyboardInterrupt)
    with pytest.raises(_sqlite3.ProgrammingError):
        r._db.execute("SELECT 1")
    with TaskRunner([Task("t", [interrupt])], db_path=db, reporter=PlainReporter()) as r2:
        assert [f["task"] for f in r2.failures()] == ["t"]
    r.close()


def test_process_route_raises_without_a_transport(monkeypatch):
    """Configured for more than one process with neither the host exchange
    nor ``torch.distributed`` up, the task graph's collectives raise
    instead of quietly doing nothing."""
    from fm_returnprediction_tpu_torch.taskgraph import tasks

    assert process_route() is None and tasks._is_primary()
    monkeypatch.setenv("FMRP_DIST_COORDINATOR", "127.0.0.1:9")
    monkeypatch.setenv("FMRP_DIST_PROCS", "2")
    monkeypatch.setenv("FMRP_DIST_PROC_ID", "1")
    with pytest.raises(RuntimeError, match="neither the host exchange"):
        process_route()
    with pytest.raises(RuntimeError, match="configured for 2 processes"):
        TaskRunner._consensus(True, np.any)
    with pytest.raises(RuntimeError, match="configured for 2 processes"):
        tasks._primary_writes("tag", lambda: None)


def test_build_docs_site(tmp_path):
    pytest.importorskip("markdown")
    from fm_returnprediction_tpu.taskgraph.docs_site import build_docs_site as jax_build
    from fm_returnprediction_tpu_torch.taskgraph.docs_site import build_docs_site

    base = tmp_path
    (base / "README.md").write_text("# Title\n\nSome `code` and a table:\n\n"
                                    "| a | b |\n|---|---|\n| 1 | 2 |\n")
    (base / "docs").mkdir()
    (base / "docs" / "architecture.md").write_text("## Arch\n\ntext\n")
    nb = base / "docs" / "notebooks"
    nb.mkdir()
    (nb / "driver.html").write_text("<html><body>nb</body></html>")
    site = base / "docs" / "site"
    written = build_docs_site(base, site)
    index = (site / "index.html").read_text()
    assert "<table>" in index and "<code>code</code>" in index
    assert 'href="architecture.html"' in index
    assert 'href="notebooks/driver.html"' in index
    assert (site / "architecture.html").is_file()
    assert (site / "notebooks" / "driver.html").read_text().endswith("</html>")
    assert (site / ".nojekyll").is_file()
    assert all(p.exists() for p in written)
    want = jax_build(base, tmp_path / "jax_site")
    assert [p.name for p in written] == [p.name for p in want]
    for got, ref in zip(written, want):
        assert got.read_bytes() == ref.read_bytes(), got.name


# -- the panel checkpoint ------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dense_panel_checkpoint_roundtrip(tmp_path, writer):
    """The port reads the JAX package's npz and the JAX package the port's:
    the same keys, values and dtypes; the port's values land as a tensor on
    the device asked for."""
    import torch

    from fm_returnprediction_tpu.panel.dense import DensePanel as JaxPanel
    from fm_returnprediction_tpu_torch.panel.dense import DensePanel

    rng = np.random.default_rng(5)
    fields = dict(
        mask=rng.random((6, 4)) > 0.3,
        months=np.array(["2001-01-31", "2001-02-28", "2001-03-30", "2001-04-30",
                         "2001-05-31", "2001-06-29"], dtype="datetime64[ns]"),
        ids=np.array([10001, 10002, 10003, 10004]),
        var_names=["retx", "log_size", "beta"],
    )
    values = rng.standard_normal((6, 4, 3)).astype(np.float32)
    p = tmp_path / "ckpt" / "panel.npz"
    if writer == "port":
        DensePanel(values=torch.from_numpy(values), **fields).save(p)
        back = JaxPanel.load(p)
        got_values = np.asarray(back.values)
        own = DensePanel.load(p, device="cpu")
        assert isinstance(own.values, torch.Tensor) and own.values.dtype == torch.float32
        np.testing.assert_array_equal(own.values.numpy(), values)
    else:
        JaxPanel(values=values, **fields).save(p)
        back = DensePanel.load(p, device="cpu")
        assert isinstance(back.values, torch.Tensor) and back.values.device.type == "cpu"
        got_values = back.values.numpy()
    assert got_values.dtype == np.float32
    np.testing.assert_array_equal(got_values, values)
    np.testing.assert_array_equal(back.mask, fields["mask"])
    np.testing.assert_array_equal(back.months, fields["months"])
    np.testing.assert_array_equal(back.ids, fields["ids"])
    assert back.var_names == fields["var_names"]
    with np.load(p, allow_pickle=False) as z:
        assert sorted(z.files) == ["ids", "mask", "months", "values", "var_names"]


def test_backend_toggle_invalidates_pull(tmp_path):
    from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig
    from fm_returnprediction_tpu_torch.taskgraph.tasks import build_tasks

    raw, processed, out = tmp_path / "raw", tmp_path / "p", tmp_path / "o"

    def tasks_for(synthetic):
        ts = build_tasks(synthetic=synthetic,
                         synthetic_config=SyntheticConfig(n_firms=20, n_months=24),
                         raw_dir=raw, processed_dir=processed, output_dir=out, device="cpu")
        assert ("parity" in [t.name for t in ts]) is not synthetic
        (t,) = [t for t in ts if t.name == "pull_data"]
        t.task_dep = []
        return t

    with TaskRunner([tasks_for(True)], db_path=tmp_path / "db.sqlite",
                    reporter=PlainReporter()) as r:
        assert r.run()
        assert r.is_up_to_date(tasks_for(True))
        assert not r.is_up_to_date(tasks_for(False))


# -- the synthetic DAG in both packages ---------------------------------------

DAG_CONFIG = dict(n_firms=40, n_months=90)
DAG_ARTIFACTS = ("table_1.pkl", "table_2.pkl", "figure_1.pdf", "decile_sorts.pkl",
                 "data_saved.marker", "specgrid_scenarios.csv", "backtest.csv")


def _run_dag(build_tasks, synthetic_config, work: Path, db: Path, **kw):
    tasks = build_tasks(synthetic=True, synthetic_config=synthetic_config,
                        raw_dir=work / "raw", processed_dir=work / "processed",
                        output_dir=work / "out", **kw)
    with TaskRunner(tasks, db_path=db, reporter=PlainReporter()) as r:
        assert r.run()
        up = {t.name: r.is_up_to_date(t) for t in tasks}
    return tasks, up


@pytest.fixture(scope="module")
def dags(tmp_path_factory):
    """The JAX DAG and the port's on the same synthetic universe, float64
    on both sides; the port's ran twice (the rerun's actions counted)."""
    from fm_returnprediction_tpu import settings as jax_settings
    from fm_returnprediction_tpu.data.synthetic import SyntheticConfig as JaxConfig
    from fm_returnprediction_tpu.taskgraph.tasks import build_tasks as jax_build
    from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig
    from fm_returnprediction_tpu_torch.taskgraph import tasks as port_tasks

    root = tmp_path_factory.mktemp("dags")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_settings.d, "DTYPE", "float64")
        mp.setenv("DTYPE", "float64")
        jax_tasks, _ = _run_dag(jax_build, JaxConfig(**DAG_CONFIG), root / "jax",
                                root / "jax.sqlite")
        tasks, first = _run_dag(port_tasks.build_tasks, SyntheticConfig(**DAG_CONFIG),
                                root / "port", root / "port.sqlite", device="cpu")
        mtimes = {p: p.stat().st_mtime_ns for p in (root / "port").rglob("*") if p.is_file()}
        ran = []
        for t in tasks:
            t.actions = [lambda name=t.name: ran.append(name)]
        with TaskRunner(tasks, db_path=root / "port.sqlite", reporter=PlainReporter()) as r:
            assert r.run()
        rerun_mtimes = {p: p.stat().st_mtime_ns for p in mtimes}
    return dict(jax=root / "jax", port=root / "port", first=first, ran=ran,
                unchanged=mtimes == rerun_mtimes, names=[t.name for t in jax_tasks])


def test_synthetic_dag_end_to_end(dags):
    """Every task of the port's DAG runs, writes the reference's artifact
    set, and is up to date afterwards; the rerun runs no action and
    touches no file."""
    port = dags["port"]
    for artifact in DAG_ARTIFACTS:
        assert (port / "out" / artifact).exists(), artifact
    assert (port / "processed" / "lewellen_panel.npz").exists()
    assert (port / "processed" / "serving_state.npz").exists()
    assert [n for n, up in dags["first"].items() if not up] == []
    assert set(dags["first"]) == set(dags["names"])
    assert dags["ran"] == [] and dags["unchanged"]
    assert sorted(p.name for p in (dags["jax"] / "out").iterdir()) == \
        sorted(p.name for p in (port / "out").iterdir())


def _frames_close(got: pd.DataFrame, want: pd.DataFrame, rtol: float, exact_rows=()):
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    g, w = got.to_numpy(dtype=float), want.to_numpy(dtype=float)
    exact = np.isin(np.asarray(got.index), list(exact_rows))
    np.testing.assert_array_equal(g[exact], w[exact])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[~exact], w[~exact], rtol=rtol, atol=0, equal_nan=True)


def test_dag_panel_and_tables_match_the_jax_dag(dags):
    from fm_returnprediction_tpu.panel.dense import DensePanel as JaxPanel
    from fm_returnprediction_tpu_torch.panel.dense import DensePanel

    got = DensePanel.load(dags["port"] / "processed" / "lewellen_panel.npz", device="cpu")
    want = JaxPanel.load(dags["jax"] / "processed" / "lewellen_panel.npz")
    assert got.var_names == want.var_names
    np.testing.assert_array_equal(got.mask, want.mask)
    g, w = got.values.numpy(), np.asarray(want.values)
    assert g.dtype == w.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=1e-10, atol=0, equal_nan=True)
    t1, w1 = (pd.read_pickle(d / "out" / "table_1.pkl") for d in (dags["port"], dags["jax"]))
    n_cols = [c for c in w1.columns if c[1] == "N"]
    np.testing.assert_array_equal(t1[n_cols].to_numpy(), w1[n_cols].to_numpy())
    _frames_close(t1.drop(columns=n_cols), w1.drop(columns=n_cols), 1e-10)
    t2, w2 = (pd.read_pickle(d / "out" / "table_2.pkl") for d in (dags["port"], dags["jax"]))
    assert t2.equals(w2)
    assert json.loads((dags["port"] / "processed" / "factors_dict.json").read_text()) == \
        json.loads((dags["jax"] / "processed" / "factors_dict.json").read_text())


def test_dag_deciles_and_serving_state_match_the_jax_dag(dags):
    from fm_returnprediction_tpu.serving.state import ServingState as JaxState
    from fm_returnprediction_tpu_torch.serving.state import ServingState

    d1, d2 = (pd.read_pickle(d / "out" / "decile_sorts.pkl") for d in (dags["port"], dags["jax"]))
    assert d1.shape == (13, 3)
    _frames_close(d1, d2, 1e-8, exact_rows=("Months",))
    got = ServingState.load(dags["port"] / "processed" / "serving_state.npz")
    want = JaxState.load(dags["jax"] / "processed" / "serving_state.npz")
    assert got.xvars == want.xvars and np.isfinite(got.coef).any()
    np.testing.assert_array_equal(got.months, want.months)
    for name in ("coef", "slopes_bar", "intercept_bar", "gram", "moment", "ysum", "yy"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0, equal_nan=True, err_msg=name)
    for name in ("n_obs", "month_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("x_lo", "x_hi"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-10,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("artifact", ["specgrid_scenarios.csv", "backtest.csv"])
def test_dag_sweeps_match_the_jax_dag(dags, artifact):
    got, want = (pd.read_csv(d / "out" / artifact) for d in (dags["port"], dags["jax"]))
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if want[c].dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
            np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-13, equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)
    knobs = artifact.replace(".csv", ".knobs.json")
    assert json.loads((dags["port"] / "out" / knobs).read_text()) == \
        json.loads((dags["jax"] / "out" / knobs).read_text())


# -- the command line ----------------------------------------------------------


def test_cli_main_runs_list_and_tasks(tmp_path):
    """``python -m fm_returnprediction_tpu_torch.taskgraph`` in a clean
    subprocess: ``--list``, then ``pull_data`` on the CPU; without
    ``--device cpu`` the command raises before any task runs (no GPU
    here), and ``--db`` defaults to the port's own state file."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "DATA_DIR": str(tmp_path / "data"),
           "OUTPUT_DIR": str(tmp_path / "out")}
    env.pop("BACKEND", None)
    cmd = [sys.executable, "-m", "fm_returnprediction_tpu_torch.taskgraph", "--synthetic",
           "--db", str(tmp_path / "db.sqlite")]
    listing = subprocess.run(cmd + ["--list", "--device", "cpu"], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
    assert listing.returncode == 0, listing.stderr[-800:]
    for name in ("config", "pull_data", "build_panel", "reports", "serve_state", "specgrid",
                 "backtest", "latex"):
        assert name in listing.stdout
    assert "parity" not in listing.stdout
    run = subprocess.run(cmd + ["--device", "cpu", "pull_data"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-800:]
    assert any((tmp_path / "data" / "raw").glob("*.parquet"))
    assert (tmp_path / "out" / "task_timings.json").exists()
    no_gpu = subprocess.run(cmd + ["pull_data"], cwd=tmp_path, env=env,
                            capture_output=True, text=True, timeout=300)
    assert no_gpu.returncode != 0 and "no CUDA device" in no_gpu.stderr
    from fm_returnprediction_tpu_torch.taskgraph.engine import DB_NAME

    assert DB_NAME == ".fmrp-torch-task-db.sqlite"
    assert DB_NAME in (REPO / ".gitignore").read_text()


# -- the WRDS route of pull_data, the trace wrapper ----------------------------


def test_wrds_dag_checkpoint_equals_load_or_build_panel(tmp_path, monkeypatch):
    """``pull_data`` through the WRDS pullers against a stand-in ``wrds``
    module answering the five queries from ``generate_benchscale_wrds``'s
    frames, then ``build_panel``: the loaded checkpoint is
    ``load_or_build_panel``'s panel of the same raw directory, bit for bit.
    ``FMRP_TRACE`` wraps the build in a profiler capture."""
    import types

    import torch

    from fm_returnprediction_tpu_torch.data.benchscale import generate_benchscale_wrds
    from fm_returnprediction_tpu_torch.panel.dense import DensePanel
    from fm_returnprediction_tpu_torch.pipeline import load_or_build_panel
    from fm_returnprediction_tpu_torch.taskgraph.tasks import PANEL_FILE, build_tasks

    frames = generate_benchscale_wrds(n_permnos=60, n_months=40)
    queries = []

    class Connection:
        def __init__(self, wrds_username=""):
            pass

        def raw_sql(self, sql, date_cols=None):
            queries.append(sql)
            for table, key in (("dsf_v2", "crsp_d"), ("msf_v2", "crsp_m"),
                               ("comp.funda", "comp"), ("ccmxpf_linktable", "ccm"),
                               ("dsix", "crsp_index_d")):
                if table in sql:
                    return frames[key].drop(columns=["jdate"], errors="ignore").copy()
            raise AssertionError(sql)

        def close(self):
            pass

    fake = types.ModuleType("wrds")
    fake.Connection = Connection
    monkeypatch.setitem(sys.modules, "wrds", fake)
    monkeypatch.setenv("FMRP_TRACE", str(tmp_path / "trace"))
    tasks = build_tasks(raw_dir=tmp_path / "raw", processed_dir=tmp_path / "p",
                        output_dir=tmp_path / "o", device="cpu")
    with TaskRunner(tasks, db_path=tmp_path / "db.sqlite", reporter=PlainReporter()) as r:
        assert r.run(["build_panel"])
    assert len(queries) == 5
    assert (tmp_path / "raw" / "_data_backend.txt").read_text() == "wrds"
    assert (tmp_path / "trace" / "profile_trace.json").exists()
    got = DensePanel.load(tmp_path / "p" / PANEL_FILE, device="cpu")
    want, _ = load_or_build_panel(tmp_path / "raw", device="cpu")
    assert got.var_names == want.var_names
    assert torch.equal(torch.isnan(got.values), torch.isnan(want.values))
    assert np.array_equal(got.values.numpy(), want.values.numpy(), equal_nan=True)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.months, want.months)


# -- the notebook tasks --------------------------------------------------------


def test_notebook_tasks_on_a_written_notebook(tmp_path, monkeypatch):
    """``build_notebook_tasks`` on a notebook this test writes (the repo's
    notebook drives the JAX package): converted to a script, executed to
    HTML, copied into the docs directory, and up to date on a rerun."""
    pytest.importorskip("nbconvert")
    nbformat = pytest.importorskip("nbformat")
    from fm_returnprediction_tpu_torch.taskgraph.tasks import build_notebook_tasks

    monkeypatch.setenv("PYTHONPATH", str(REPO))   # the executing kernel imports the port
    nb_dir = tmp_path / "notebooks"
    nb_dir.mkdir()
    nb = nbformat.v4.new_notebook(metadata={
        "kernelspec": {"name": "python3", "display_name": "Python 3", "language": "python"},
        "language_info": {"name": "python", "file_extension": ".py"}})
    nb.cells = [nbformat.v4.new_code_cell(
        "from fm_returnprediction_tpu_torch.settings import config\n"
        "print('backend', config('BACKEND'))")]
    nbformat.write(nb, nb_dir / "port_driver.ipynb")
    tasks = build_notebook_tasks(nb_dir, tmp_path / "out", tmp_path / "docs")
    names = [t.name for t in tasks]
    assert names[:2] == ["convert_notebooks", "run_notebooks"]
    run_only = [t for t in tasks if t.name != "docs_site"]
    with TaskRunner(run_only, db_path=tmp_path / "db.sqlite", reporter=PlainReporter()) as r:
        assert r.run(), r.failures()
        assert (tmp_path / "out" / "notebooks" / "port_driver.py").exists()
        html = (tmp_path / "docs" / "port_driver.html").read_text()
        assert "backend" in html
        assert all(r.is_up_to_date(t) for t in run_only)
    assert build_notebook_tasks(tmp_path / "empty", tmp_path / "out") == []


# -- across processes ----------------------------------------------------------


@pytest.mark.timeout(420)
def test_two_process_taskgraph_dag_host_exchange(tmp_path):
    """The port's DAG across 2 real processes sharing a filesystem, over the
    host exchange: process-0-only writes with barriers, an asymmetric-
    staleness rerun that deadlocks without the runner's stale consensus,
    then a one-sided failure that stops both sides (the worker script
    imports the port only)."""
    from fm_returnprediction_tpu_torch.parallel.distributed import free_port

    worker = Path(__file__).parent / "mp_torch_taskgraph_worker.py"
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2", str(port),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    deadline = time.monotonic() + 360
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail("task-graph workers hung:\n" + "\n---\n".join(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} rc={p.returncode}:\n{out}"
        assert f"TG_OK {i}" in out, out
