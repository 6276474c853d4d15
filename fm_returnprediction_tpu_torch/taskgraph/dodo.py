"""doit entry point for the port's task graph.

The native runner is ``python -m fm_returnprediction_tpu_torch.taskgraph``:
the in-package engine keeps doit's file_dep/targets/uptodate semantics, so
doit is optional. Where doit is installed, this shim gives it the SAME
graph:

    doit -f fm_returnprediction_tpu_torch/taskgraph/dodo.py [list | task ...]

One ``task_<name>`` creator per node of ``build_tasks() +
build_notebook_tasks()``, each returning the node as a doit task dict, and
eight gate tasks, each one pytest invocation over the port's test files of
one layer (exit 1 on any failure): ``robustness_smoke``, ``grid_parity``,
``estimator_parity``, ``backtest_parity``, ``multiprocess_smoke``,
``transport_parity``, ``topology_smoke`` and ``obs_smoke``. doit runs
from this file's directory, so every path in a task is absolute.

Environment (the settings layer the native runner reads):

- ``FMRP_SYNTHETIC=1`` — build from the synthetic universe instead of the
  WRDS pulls (no credentials needed);
- ``BACKEND`` (``cuda`` or ``cpu``) — the compute tasks' device; the
  directory keys ``DATA_DIR``, ``OUTPUT_DIR``, ...

Run directly (``python dodo.py``) without doit installed, it prints the
native runner's command.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# doit (and ``python dodo.py``) put this file's directory on the path, not
# the repo's: the package is found through the repo, appended last
if str(REPO) not in sys.path:
    sys.path.append(str(REPO))

# the port's test files of each gate's layer
GATES = {
    "robustness_smoke": (
        "fleet, overload and fault-injection suite (supervision, autoscale, "
        "brownout, crash recovery, checkpoints, retries)",
        ("test_torch_fleet.py", "test_torch_fleet_overload.py", "test_torch_resilience.py"),
    ),
    "grid_parity": (
        "spec-grid differential suite (Gram contraction and its variants, the "
        "solve, the Gram bank, the sharded grid) against the reference",
        ("test_torch_grams.py", "test_torch_grams_variants.py", "test_torch_solve.py",
         "test_torch_specgrid.py", "test_torch_grambank.py", "test_torch_specgrid_mesh.py"),
    ),
    "estimator_parity": (
        "estimator family suite (FWL, absorbed fixed effects, IV, pooled and "
        "clustered SEs, the streaming bootstrap, bank estimator queries)",
        ("test_torch_estimators.py",),
    ),
    "backtest_parity": (
        "backtest suite (scan vs refit paths, OOS R2/IC/decile oracles, "
        "consumer quotes, the zero-contraction ledger)",
        ("test_torch_backtest.py",),
    ),
    "multiprocess_smoke": (
        "cross-process suite (host exchange, the grid over worker processes, "
        "process replicas, the hierarchy across processes)",
        ("test_torch_multiprocess.py", "test_torch_multihost.py"),
    ),
    "transport_parity": (
        "shared-memory data plane suite (ring protocol, frames, fleet shm vs "
        "socket, grid shm vs frames)",
        ("test_torch_transport.py",),
    ),
    "topology_smoke": (
        "topology controller suite (probe ladder, repair, sweep, any-shape "
        "recovery, the degraded grid)",
        ("test_torch_topology.py",),
    ),
    "obs_smoke": (
        "observability suite (spans, metrics, exports, cross-process traces, "
        "flight annex, timeline merge, the cost ledger)",
        ("test_torch_telemetry.py", "test_torch_obs_distributed.py",
         "test_torch_perf_obs.py"),
    ),
}


def _doit_dict(task) -> dict:
    """One ``taskgraph.engine.Task`` → a doit task dict (the engine's field
    names are doit's; paths become strings)."""
    d = {
        "actions": list(task.actions),
        "file_dep": [str(p) for p in task.file_dep],
        "targets": [str(p) for p in task.targets],
        "task_dep": list(task.task_dep),
        "doc": task.doc,
        "verbosity": 2,
    }
    if task.uptodate:
        d["uptodate"] = list(task.uptodate)
    return d


def _all_tasks():
    from fm_returnprediction_tpu_torch.settings import apply_backend
    from fm_returnprediction_tpu_torch.taskgraph.tasks import (
        build_notebook_tasks,
        build_tasks,
    )

    synthetic = os.environ.get("FMRP_SYNTHETIC", "0") == "1"
    return (build_tasks(synthetic=synthetic, device=apply_backend())
            + build_notebook_tasks())


def _make_creator(task):
    def creator():
        return _doit_dict(task)

    creator.__name__ = f"task_{task.name}"
    creator.__doc__ = task.doc
    return creator


def _make_gate(name: str, doc: str, files):
    paths = " ".join(str(REPO / "tests" / f) for f in files)

    def creator():
        return {
            "actions": [f"cd {REPO} && {sys.executable} -m pytest {paths} -q "
                        "-p no:cacheprovider"],
            "file_dep": [],
            "targets": [],
            "task_dep": [],
            "doc": f"{doc} — exit 1 on any failure",
            "verbosity": 2,
            "uptodate": [False],  # a test suite: always rerun
        }

    creator.__name__ = f"task_{name}"
    creator.__doc__ = doc
    return creator


# doit discovers module-level ``task_*`` callables: one per graph node, so
# ``doit list`` shows the native runner's task names, and one per gate
for _t in _all_tasks():
    globals()[f"task_{_t.name}"] = _make_creator(_t)
for _name, (_doc, _files) in GATES.items():
    globals()[f"task_{_name}"] = _make_gate(_name, _doc, _files)
del _t, _name, _doc, _files


if __name__ == "__main__":
    try:
        from doit.cmd_base import ModuleTaskLoader
        from doit.doit_cmd import DoitMain
    except ImportError:
        print(
            "doit is not installed. Use the native runner instead:\n"
            "    python -m fm_returnprediction_tpu_torch.taskgraph [task ...]\n"
            "(the same DAG and semantics; this dodo.py is a doit shim)."
        )
    else:
        raise SystemExit(DoitMain(ModuleTaskLoader(globals())).run(sys.argv[1:] or ["run"]))
