"""The port's perf-regression sentinel (``telemetry.regress``) vs the JAX
package's: for the same ``BENCH_*.json`` inputs, the same report (its JSON
form and its text) and the same command-line exit codes and output.

The synthetic histories are those of ``tests/test_perf_regress.py``; the
repo's own ``BENCH_r*.json`` trajectory goes through both sentinels too.
"""

import glob
import json
from pathlib import Path

import pytest

from fm_returnprediction_tpu.telemetry import regress as jax_regress
from fm_returnprediction_tpu_torch.telemetry import regress

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent


def _write_round(tmp_path, n, metric, value, extra=None, name=None):
    doc = {"n": n, "parsed": {"metric": metric, "value": value, "unit": "s",
                              "vs_baseline": 1.0, "extra": extra or {}}}
    path = tmp_path / (name or f"BENCH_r{n:02d}.json")
    path.write_text(json.dumps(doc))
    return path


def _write_history(tmp_path, histories):
    n_rounds = max(len(v) for v in histories.values())
    paths = []
    for i in range(n_rounds):
        extra = {k: vals[i] for k, vals in histories.items()
                 if i < len(vals) and vals[i] is not None}
        paths.append(_write_round(tmp_path, i + 1, "headline_s",
                                  extra.pop("headline_s", 1.0), extra=extra))
    return paths


def _both(paths, **kw):
    port = regress.analyze(regress.load_rounds(paths), **kw)
    ref = jax_regress.analyze(jax_regress.load_rounds(paths), **kw)
    return port, ref


HISTORIES = {
    "regression": {"headline_s": [10.0, 5.0, 4.0], "warm_s": [10.0, 4.0, 13.0],
                   "steady_s": [1.0, 1.05, 1.1]},
    "higher_is_better": {"serving_qps": [100.0, 150.0, 80.0], "x_speedup": [2.0, 2.1, 2.2]},
    "flappy": {"flappy_s": [1.0, 1.6, 1.0, 1.6, 1.0, 1.55]},
    "abs_floor": {"tiny_s": [0.001, 0.001, 0.002]},
    "statuses": {"old_s": [1.0, 1.0, None], "fresh_s": [None, None, 1.0],
                 "signed_pct": [-3.0, 2.0, 5.0]},
    "nested": {"headline_s": [2.0, 1.0, 3.0], "stage_s": [1.0, 1.0, 1.0]},
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_reports_equal_the_jax_sentinel(tmp_path, name):
    port, ref = _both(_write_history(tmp_path, HISTORIES[name]))
    assert port.to_json() == ref.to_json()
    assert port.format_text(verbose=True) == ref.format_text(verbose=True)
    assert port.ok == ref.ok


def test_verdicts_mirror_the_reference_semantics(tmp_path):
    port, _ = _both(_write_history(tmp_path, HISTORIES["regression"]))
    by_key = {v.key: v.status for v in port.verdicts}
    assert by_key == {"headline_s": "improved", "warm_s": "regressed", "steady_s": "ok"}
    assert [v.key for v in port.regressions] == ["warm_s"]


def test_shape_and_device_qualified_series_and_disabled_sections(tmp_path):
    paths = [
        _write_round(tmp_path, 1, "wall_s", 1.0, extra={
            "kernel_s": 2.0, "kernel_shape": "T10", "device": "cpu"}),
        _write_round(tmp_path, 2, "wall_s", 1.1, extra={
            "kernel_s": 9.0, "kernel_shape": "T20", "device": "cpu",
            "serving": {"disabled": "flaky here"}}),
        _write_round(tmp_path, 3, "wall_s", 1.2, extra={
            "kernel_s": 2.1, "kernel_shape": "T10", "device": "gpu",
            "serving_p99_ms": 3.0, "serving": {"disabled": "flaky here"}}),
    ]
    port, ref = _both(paths, floor_rel=0.1, abs_floor=0.01)
    assert port.to_json() == ref.to_json()
    assert port.disabled == (("serving", "flaky here"),)


def test_foreign_files_and_ordering(tmp_path):
    p2 = _write_round(tmp_path, 2, "wall_s", 2.0)
    p1 = _write_round(tmp_path, 1, "wall_s", 1.0)
    (tmp_path / "BENCH_r01_self.json").write_text(
        json.dumps({"parsed": {"metric": "wall_s", "value": 1.5, "extra": {}}}))
    (tmp_path / "junk.json").write_text("not json at all")
    files = [p2, p1, tmp_path / "BENCH_r01_self.json", tmp_path / "junk.json"]
    assert [r.label for r in regress.load_rounds(files)] == \
        [r.label for r in jax_regress.load_rounds(files)] == \
        ["BENCH_r01", "BENCH_r01_self", "BENCH_r02"]
    assert regress.load_round(tmp_path / "missing.json") is None


@pytest.mark.parametrize("key", [
    "pipeline_warm_s", "serving_p99_ms", "specgrid_gram_mb", "guard_overhead_table2_pct",
    "serving_qps", "specgrid_speedup_warm", "daily_fullscale_rows_per_s", "vs_baseline",
    "specgrid_programs", "jax_cache_before.entries", "real_pipeline_stage_s.table_2",
    "serving_ledger_compile_s", "kernel_utilization@T10@cpu",
])
def test_direction_equals_the_jax_sentinel(key):
    assert regress.direction(key) == jax_regress.direction(key)


@pytest.mark.parametrize("argv_tail", [[], ["--no-fail"], ["--json"], ["--verbose"],
                                       ["--floor-rel", "10", "--abs-floor", "0"]])
def test_cli_exit_codes_and_output_equal(tmp_path, capsys, argv_tail):
    _write_round(tmp_path, 1, "wall_s", 1.0)
    _write_round(tmp_path, 2, "wall_s", 5.0)
    files = sorted(str(p) for p in tmp_path.glob("BENCH_*.json"))
    rc_port = regress.main([*files, *argv_tail])
    out_port = capsys.readouterr()
    rc_ref = jax_regress.main([*files, *argv_tail])
    out_ref = capsys.readouterr()
    assert rc_port == rc_ref
    assert out_port.out == out_ref.out


def test_cli_too_little_history_exits_zero(tmp_path, capsys):
    p = _write_round(tmp_path, 1, "wall_s", 1.0)
    assert regress.main([str(p)]) == jax_regress.main([str(p)]) == 0
    assert "need >=2" in capsys.readouterr().err


def test_repo_bench_history_reads_the_same():
    files = sorted(glob.glob(str(REPO / "BENCH_r*.json")))
    assert len(files) >= 2
    port, ref = _both(files)
    assert port.to_json() == ref.to_json()
