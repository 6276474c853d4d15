"""The benchmark's files: every cell, configuration and metric is found by its
name, names and units keep to the contract's characters, and nothing a run
loads is JAX or the JAX package."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
FORBIDDEN = {"jax", "jaxlib", "flax", "fm_returnprediction_tpu"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in BENCH["workloads"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
               and 0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
               for m in BENCH["per_layer"])
    assert "portbench" in BENCH["paths"]
    assert not any(str(p).endswith("_torch") for p in BENCH["paths"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(work):
    cell = json.loads((PB / "cells" / f"{work['name']}.json").read_text())
    assert (PB / "traffic" / f"{work['traffic']}.py").is_file()
    assert work["config"] in {c["name"] for c in BENCH["configs"]}
    assert work["chips"] in (1, 4)
    assert len(work["why"]) <= 200
    assert all(isinstance(v, (int, float)) for v in cell["limits"].values())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert data["reduced"] == cfg["reduced"]
    assert cfg["file"].startswith("portbench/")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert (PB / "metrics" / f"{metric['name']}.py").is_file()
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= names


def test_names_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]] + [m["name"] for m in METRICS])
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)


def test_every_cell_reports_setup_and_a_metric_of_each_kind():
    from portbench.harness import reported

    for work in BENCH["workloads"]:
        e2e = {m["name"] for m in reported(BENCH, work["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported(BENCH, work["name"], trace=True)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_either_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & (FORBIDDEN | {"fm_returnprediction_tpu_torch"}), tops


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    """A whole run of a small cell on the CPU, in a fresh interpreter: what
    it loads, compared by whole top-level names (the port's name begins with
    the JAX package's)."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.reference.lewellen, portbench.reference.fm\n"
        "ref_tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from portbench.harness import run_cell, forbidden_modules\n"
        "res, _ = run_cell('ghz.grid', 11, 0.2, False, device='cpu',\n"
        "                  sizes={'n_firms': 300, 'n_months': 60, 'n_chars': 6})\n"
        "print(json.dumps({'ref': ref_tops, 'bad': forbidden_modules(),\n"
        "                  'port': 'fm_returnprediction_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["port"]
    assert "fm_returnprediction_tpu_torch" not in got["ref"]
    assert not set(got["ref"]) & FORBIDDEN
