"""The port's resilience layer: fault sites, stage checkpoints, atomic writes.

- ``resilience.faults``: a plan triggers by call count (skip, times, heal),
  by a seeded probability that replays exactly, nests and restores, stalls
  without raising, and travels to a child process through
  ``chaos_env``/``install_plan_from_env`` (``proc`` filtering included);
- ``resilience.checkpoint.StageCheckpointer``: load-or-compute, a new
  fingerprint invalidates every stage, a corrupt or missing stage file is
  recomputed with a warning, and ``OUTCOMES`` counts hits, misses,
  corruptions and saves;
- ``run_pipeline(checkpoint_dir=...)``: a crash injected at
  ``pipeline.serving_state`` leaves Table 1, Table 2 and the decile table
  checkpointed; the rerun does not re-enter ``build_table_1`` or
  ``table_2_cells``, sweeps the universes without the decile legs, and its
  tables and serving state equal a fresh run's (from a synthetic universe and from a
  raw directory); a truncated or flipped decile checkpoint is counted
  corrupt and swept again, with the tables equal to a fresh run's; the
  prepared-inputs entry refuses ``checkpoint_dir``;
- ``utils.cache``: a writer that fails mid-write leaves the old file and no
  temporary files, and the cache fault sites corrupt what they are given;
- the four ``pipeline.panel`` corruptors end at the same guard severity and
  violation names in both packages (``tests/test_chaos.py``).
"""

import contextlib
import os
import re
import time

import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from fm_returnprediction_tpu.pipeline import run_pipeline as jax_run_pipeline
from fm_returnprediction_tpu.resilience import faults as jax_faults
from fm_returnprediction_tpu.resilience.errors import (
    ContractViolationError as JaxContractViolationError,
)
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs
from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig, write_synthetic_cache
from fm_returnprediction_tpu_torch.resilience import checkpoint as port_checkpoint
from fm_returnprediction_tpu_torch.resilience import faults
from fm_returnprediction_tpu_torch.resilience.checkpoint import StageCheckpointer
from fm_returnprediction_tpu_torch.resilience.errors import (
    ContractViolationError,
    CorruptArtifactError,
    InjectedFault,
)
from fm_returnprediction_tpu_torch.resilience.faults import FaultPlan, FaultSpec, fault_site
from fm_returnprediction_tpu_torch.utils import cache

pytestmark = pytest.mark.torch_port


# -- fault plans -------------------------------------------------------------


def test_fault_site_without_a_plan_returns_its_payload():
    payload = object()
    assert fault_site("anything", payload=payload) is payload


@pytest.mark.parametrize("times, skip, fired", [(2, 1, [False, True, True, False]),
                                                (-1, 2, [False, False, True, True]),
                                                (1, 0, [True, False, False, False])])
def test_fault_plan_counts_skip_and_heal(times, skip, fired):
    with FaultPlan({"s": FaultSpec(times=times, skip=skip)}) as plan:
        got = []
        for _ in range(4):
            try:
                fault_site("s")
                got.append(False)
            except InjectedFault:
                got.append(True)
    assert got == fired
    assert plan.calls["s"] == 4 and plan.fired["s"] == sum(fired)


def test_fault_plan_probability_replays_exactly():
    def pattern(seed):
        out = []
        with FaultPlan({"p": FaultSpec(times=-1, probability=0.5)}, seed=seed):
            for _ in range(20):
                try:
                    fault_site("p")
                    out.append(False)
                except InjectedFault:
                    out.append(True)
        return out

    a = pattern(3)
    assert a == pattern(3) and any(a) and not all(a)
    assert pattern(4) != a


def test_fault_plan_mutate_and_nesting():
    with FaultPlan({"x": FaultSpec(times=-1)}):
        with FaultPlan({"x": FaultSpec(times=-1, mutate=lambda p: p + 1)}):
            assert fault_site("x", payload=1) == 2      # the inner plan poisons
        with pytest.raises(InjectedFault):
            fault_site("x")                             # the outer plan is back
    assert fault_site("x", payload=1) == 1              # nothing installed


def test_fault_plan_delay_stalls_without_raising():
    with FaultPlan({"slow": FaultSpec(times=1, delay_s=0.05)}):
        start = time.perf_counter()
        assert fault_site("slow", payload="p") == "p"
        assert time.perf_counter() - start >= 0.05


@pytest.mark.parametrize("me, installed", [(None, {"a"}), ("1", {"a", "b"}), ("0", {"a"})])
def test_chaos_env_round_trip(me, installed):
    """The declarative specs travel; the one with a live callable stays in
    the parent, and the one for process "1" installs only there."""
    plan = FaultPlan({"a": FaultSpec(times=2, skip=1, exc=ConnectionError),
                      "b": FaultSpec(corrupt=True, proc="1"),
                      "live": FaultSpec(mutate=lambda p: p)}, seed=7)
    env = faults.chaos_env(plan)
    assert set(env) == {"FMRP_CHAOS_PLAN", "FMRP_CHAOS_SEED"}
    if me is not None:
        env["FMRP_PROC_INDEX"] = me
    child = faults.install_plan_from_env(env)
    try:
        assert child.seed == 7 and set(child.specs) == installed
        assert child.specs["a"].exc is ConnectionError and child.specs["a"].skip == 1
        fault_site("a")
        with pytest.raises(ConnectionError):
            fault_site("a")
    finally:
        child.__exit__()
    assert faults.chaos_env() == {}


# -- the stage checkpointer --------------------------------------------------


def _counting_compute(calls, value=None):
    def compute():
        calls["n"] += 1
        return pd.DataFrame({"v": [calls["n"] if value is None else value]})
    return compute


def test_checkpointer_load_or_compute(tmp_path):
    calls = {"n": 0}
    before = dict(port_checkpoint.OUTCOMES)
    first = StageCheckpointer(tmp_path, "fp1").frame("t", _counting_compute(calls))
    again = StageCheckpointer(tmp_path, "fp1").frame("t", _counting_compute(calls))
    assert calls["n"] == 1
    pd.testing.assert_frame_equal(first, again)
    delta = {k: port_checkpoint.OUTCOMES[k] - before.get(k, 0) for k in ("miss", "save", "hit")}
    assert delta == {"miss": 1, "save": 1, "hit": 1}


def test_checkpointer_fingerprint_invalidates(tmp_path):
    calls = {"n": 0}
    StageCheckpointer(tmp_path, "fp1").frame("t", _counting_compute(calls))
    other = StageCheckpointer(tmp_path, "fp2")
    assert not other.completed("t") and other.stages() == ()
    other.frame("t", _counting_compute(calls))
    assert calls["n"] == 2


@pytest.mark.parametrize("damage", ["garbage", "missing", "truncated"])
def test_checkpointer_corrupt_stage_recomputes(tmp_path, damage):
    calls = {"n": 0}
    StageCheckpointer(tmp_path, "fp").frame("t", _counting_compute(calls, 7))
    path = tmp_path / "t.pkl"
    if damage == "garbage":
        path.write_bytes(b"garbage")
    elif damage == "missing":
        path.unlink()
    else:
        faults.truncate_file(path)
    corrupt = port_checkpoint.OUTCOMES["corrupt"]
    ck = StageCheckpointer(tmp_path, "fp")
    with pytest.warns(UserWarning, match="recomputing"):
        out = ck.frame("t", _counting_compute(calls, 7))
    assert calls["n"] == 2 and list(out["v"]) == [7]
    assert port_checkpoint.OUTCOMES["corrupt"] == corrupt + 1
    assert StageCheckpointer(tmp_path, "fp").completed("t")  # the rebuild is recorded


# -- crash and resume --------------------------------------------------------


def _source_kw(source, tmp_path):
    if source == "synthetic":
        return dict(synthetic=True, synthetic_config=SyntheticConfig(n_firms=40, n_months=96))
    raw = tmp_path / "raw"
    write_synthetic_cache(raw, SyntheticConfig(n_firms=40, n_months=96))
    return dict(raw_data_dir=raw)


@pytest.mark.parametrize("source", ["synthetic", "raw"])
def test_crash_at_serving_state_resumes_at_the_last_completed_stage(tmp_path, monkeypatch,
                                                                    source):
    kw = dict(_source_kw(source, tmp_path), device="cpu", dtype=torch.float64,
              checkpoint_dir=tmp_path / "ckpt")
    with FaultPlan({"pipeline.serving_state": FaultSpec(times=1)}) as plan:
        with pytest.raises(OSError, match="injected fault"):
            port_pipeline.run_pipeline(**kw)
    assert plan.fired["pipeline.serving_state"] == 1
    assert {"pipeline.panel", "pipeline.table_1", "pipeline.table_2",
            "pipeline.decile_table"} <= set(plan.calls)
    saved = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert saved == ["decile_table.pkl", "manifest.json", "table_1.pkl", "table_2.pkl"]

    calls = {"build_table_1": 0, "table_2_cells": 0}
    for name in calls:
        orig = getattr(port_pipeline, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(port_pipeline, name, counted)
    hits = port_checkpoint.OUTCOMES["hit"]
    resumed = port_pipeline.run_pipeline(**kw)
    assert calls == {"build_table_1": 0, "table_2_cells": 0}
    assert port_checkpoint.OUTCOMES["hit"] == hits + 3
    # the decile table came from its checkpoint: every universe is swept,
    # as in a fresh run, without the decile legs
    assert list(resumed.sweep) == list(resumed.subset_masks)
    assert all(entry.deciles is None for entry in resumed.sweep.values())
    assert (tmp_path / "ckpt" / "serving_state.npz").exists()

    monkeypatch.undo()
    fresh = port_pipeline.run_pipeline(**{**kw, "checkpoint_dir": None})
    for name in ("table_1", "table_2", "decile_table"):
        assert getattr(resumed, name).equals(getattr(fresh, name)), name
    for key, cell in fresh.table_2_cells.items():
        for k, v in cell.items():
            np.testing.assert_array_equal(resumed.table_2_cells[key][k], v)
    for leaf in ("coef", "slopes_bar", "intercept_bar", "x_lo", "x_hi", "gram", "moment",
                 "n_obs", "month_valid"):
        np.testing.assert_array_equal(getattr(resumed.serving_state, leaf),
                                      getattr(fresh.serving_state, leaf), err_msg=leaf)


@pytest.mark.parametrize("damage", ["truncated", "flipped byte"])
def test_corrupt_decile_checkpoint_is_recomputed_on_resume(tmp_path, damage):
    kw = dict(_source_kw("synthetic", tmp_path), device="cpu", dtype=torch.float64,
              checkpoint_dir=tmp_path / "ckpt")
    with FaultPlan({"pipeline.serving_state": FaultSpec(times=1)}):
        with pytest.raises(OSError, match="injected fault"):
            port_pipeline.run_pipeline(**kw)
    path = tmp_path / "ckpt" / "decile_table.pkl"
    if damage == "truncated":
        faults.truncate_file(path)
    else:
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        path.write_bytes(bytes(raw))
    corrupt = port_checkpoint.OUTCOMES["corrupt"]
    with pytest.warns(UserWarning, match="decile_table.*recomputing"):
        resumed = port_pipeline.run_pipeline(**kw)
    assert port_checkpoint.OUTCOMES["corrupt"] == corrupt + 1
    # the sweep computed the decile legs again, as in a fresh run
    assert all(entry.deciles is not None for entry in resumed.sweep.values())
    fresh = port_pipeline.run_pipeline(**{**kw, "checkpoint_dir": None})
    for name in ("table_1", "table_2", "decile_table"):
        assert getattr(resumed, name).equals(getattr(fresh, name)), name
    # the rebuild is recorded: the next run loads every stage
    hits = port_checkpoint.OUTCOMES["hit"]
    again = port_pipeline.run_pipeline(**kw)
    assert port_checkpoint.OUTCOMES["hit"] == hits + 4
    assert again.decile_table.equals(fresh.decile_table)


def test_prepared_entry_refuses_checkpoint_dir(tmp_path):
    base, daily = make_smoke_inputs(n_firms=40, n_months=36, dtype=np.float64)
    with pytest.raises(ValueError, match="provenance"):
        port_pipeline.run_pipeline(dense_base=base, compact_daily=daily, device="cpu", checkpoint_dir=tmp_path)
    assert not any(tmp_path.iterdir())


def test_cli_takes_checkpoint_dir(tmp_path, capsys):
    argv = ["--synthetic", "--firms", "30", "--months", "40", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    port_pipeline._main(argv)
    first = capsys.readouterr().out
    port_pipeline._main(argv)
    second = capsys.readouterr().out
    assert (tmp_path / "ckpt" / "manifest.json").exists()
    assert re.search(r"^TOTAL\s+[0-9.]+s$", first, re.MULTILINE)
    # the rerun prints the same tables from the checkpoints
    assert first.split("\n\n")[:2] == second.split("\n\n")[:2]


# -- atomic writes and the cache fault sites ----------------------------------


def test_write_cache_data_is_atomic_on_failure(tmp_path, monkeypatch):
    path = tmp_path / "x.parquet"
    cache.write_cache_data(pd.DataFrame({"a": [1]}), path)

    def torn_write(self, fp, index=False):
        with open(fp, "wb") as f:
            f.write(b"PAR1garbage")
        raise OSError("disk full")

    monkeypatch.setattr(pd.DataFrame, "to_parquet", torn_write)
    with pytest.raises(OSError, match="disk full"):
        cache.write_cache_data(pd.DataFrame({"a": [1, 2]}), path)
    monkeypatch.undo()
    assert list(cache.load_cache_data(tmp_path, "x.parquet")["a"]) == [1]
    assert [f for f in os.listdir(tmp_path) if "tmp" in f] == []


@pytest.mark.parametrize("site", ["cache.write_cache_data", "cache.save_array_bundle"])
def test_cache_fault_sites_corrupt_the_written_file(tmp_path, site):
    with FaultPlan({site: FaultSpec(corrupt=True)}) as plan:
        if site == "cache.write_cache_data":
            path = cache.save_cache_data(pd.DataFrame({"a": np.arange(100.0)}), tmp_path,
                                         file_name="f.parquet")
        else:
            path = cache.save_array_bundle(tmp_path / "b", {"a": np.arange(100.0)})
    assert plan.fired[site] == 1 and path.suffix in (".parquet", ".npz")
    assert [f for f in os.listdir(tmp_path) if "tmp" in f] == []
    if site == "cache.write_cache_data":
        with pytest.raises(Exception):
            cache.load_cache_data(tmp_path, path.name)
    else:
        with pytest.raises(CorruptArtifactError):
            cache.load_array_bundle(path)


# -- the panel corruptors in both packages -------------------------------------


CORRUPTORS = ["corrupt_panel_duplicate_id", "corrupt_panel_stale_month",
              "corrupt_panel_scale_spike", "corrupt_panel_permute_firms"]
EXPECTED = {"corrupt_panel_duplicate_id": ("fail", "panel.key_unique"),
            "corrupt_panel_stale_month": ("fail", "panel.calendar_monotone"),
            "corrupt_panel_scale_spike": ("fail", "panel.value_bounds"),
            "corrupt_panel_permute_firms": ("warn", "panel.ids_sorted")}


def _outcome(module, run, error, name, **kw):
    """(severity, violation names) of a guarded run whose panel the
    corruptor ``name`` of ``module`` poisoned at ``pipeline.panel``."""
    corruptor = getattr(module, name)
    if name == "corrupt_panel_permute_firms":
        mutate = lambda p: corruptor(p, seed=4)  # noqa: E731
    elif name == "corrupt_panel_scale_spike":
        mutate = lambda p: corruptor(p, column=-1)  # noqa: E731
    else:
        mutate = corruptor
    warns = (pytest.warns(UserWarning, match="panel.ids_sorted")
             if EXPECTED[name][0] == "warn" else contextlib.nullcontext())
    with module.FaultPlan({"pipeline.panel": module.FaultSpec(mutate=mutate)}) as plan:
        try:
            with warns:
                res = run(guard=True, make_figure=False, make_deciles=False,
                          make_serving=False, **kw)
        except error as exc:
            return "fail", sorted(set(re.findall(r"panel\.[a-z_]+", str(exc)))), None
    assert plan.fired["pipeline.panel"] == 1
    return "warn", sorted(set(res.audit.names())), res


@pytest.mark.parametrize("name", CORRUPTORS)
def test_panel_corruptors_end_alike_in_both_packages(name):
    cfg = dict(n_firms=20, n_months=36)
    port = _outcome(faults, port_pipeline.run_pipeline, ContractViolationError, name,
                    synthetic=True, synthetic_config=SyntheticConfig(**cfg), device="cpu",
                    dtype=torch.float64)
    jax = _outcome(jax_faults, jax_run_pipeline, JaxContractViolationError, name,
                   synthetic=True, synthetic_config=JaxSyntheticConfig(**cfg),
                   dtype=np.float64, compile_pdf=False)
    severity, rule = EXPECTED[name]
    assert port[:2] == jax[:2]
    assert port[0] == severity and rule in port[1]
    if severity == "warn":
        clean = port_pipeline.run_pipeline(synthetic=True, synthetic_config=SyntheticConfig(**cfg),
                                           device="cpu", dtype=torch.float64, guard=True,
                                           make_figure=False, make_deciles=False,
                                           make_serving=False)
        pd.testing.assert_frame_equal(port[2].table_2, clean.table_2)
        assert [(v["rule"], v["severity"]) for v in port[2].audit.as_dict()["violations"]] == \
            [(v["rule"], v["severity"]) for v in jax[2].audit.as_dict()["violations"]]
