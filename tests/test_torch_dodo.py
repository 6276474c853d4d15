"""The port's doit shim (``fm_returnprediction_tpu_torch/taskgraph/dodo.py``),
tested as ``tests/test_dodo.py`` tests the reference's, without doit
installed: one creator per node of the port's task graph and one per gate,
each returning a doit task dict with absolute paths (doit runs from the
shim's own directory); a direct run prints the native runner's command."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

from fm_returnprediction_tpu_torch.taskgraph.tasks import build_notebook_tasks, build_tasks

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
SHIM = REPO / "fm_returnprediction_tpu_torch" / "taskgraph" / "dodo.py"
GATES = ("robustness_smoke", "grid_parity", "estimator_parity", "backtest_parity",
         "multiprocess_smoke", "transport_parity", "topology_smoke", "obs_smoke")


@pytest.fixture(scope="module")
def shims():
    """The shim's creators, loaded once with ``FMRP_SYNTHETIC`` 0 and 1."""
    out = {}
    for synthetic in ("0", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FMRP_SYNTHETIC", synthetic)
            mp.setenv("BACKEND", "cpu")
            spec = importlib.util.spec_from_file_location("port_dodo", SHIM)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        out[synthetic] = {n: f for n, f in vars(mod).items() if n.startswith("task_")}
    return out


@pytest.mark.parametrize("synthetic", ["0", "1"])
def test_task_creators_cover_the_graph(shims, synthetic):
    creators = shims[synthetic]
    tasks = build_tasks(synthetic=synthetic == "1", device="cpu")
    nodes = [t.name for t in tasks + build_notebook_tasks()]
    assert {"config", "pull_data", "build_panel", "reports", "latex"} <= set(nodes)
    assert set(creators) == {f"task_{n}" for n in nodes + list(GATES)}
    assert "task_perf_regress" not in creators
    for name, creator in creators.items():
        d = creator()
        assert set(d) >= {"actions", "file_dep", "targets", "task_dep", "doc", "verbosity"}, name
        assert callable(d["actions"][0]) or isinstance(d["actions"][0], str)
        assert all(isinstance(p, str) and Path(p).is_absolute()
                   for p in d["file_dep"] + d["targets"]), name
        assert isinstance(d["doc"], str) and d["doc"], name
    graph = {t.name: t for t in tasks}
    assert creators["task_build_panel"]()["task_dep"] == list(graph["build_panel"].task_dep)


def test_gates_run_the_port_tests_by_absolute_path(shims):
    creators = shims["0"]
    for gate in GATES:
        d = creators[f"task_{gate}"]()
        (action,) = d["actions"]
        assert action.startswith(f"cd {REPO} && {sys.executable} -m pytest ")
        files = [w for w in action.split() if w.endswith(".py")]
        assert files, gate
        for f in files:
            assert Path(f).is_absolute() and Path(f).exists(), f
            assert Path(f).name.startswith("test_torch_"), f
        assert d["uptodate"] == [False]


def test_direct_run_points_at_native_runner(tmp_path):
    if importlib.util.find_spec("doit") is not None:
        pytest.skip("doit installed: a direct run delegates to a real doit build")
    out = subprocess.run([sys.executable, str(SHIM)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "python -m fm_returnprediction_tpu_torch.taskgraph" in out.stdout
