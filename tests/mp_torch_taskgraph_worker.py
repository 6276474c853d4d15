"""Worker of the port's two-process task-graph test
(``test_torch_taskgraph.py``): the pipeline DAG of the port, on the CPU,
across 2 processes sharing one filesystem, over the host exchange.

- phase 1: both processes run the DAG from empty state; process 0 writes
  every artifact once (``_primary_writes``), the barriers release process
  1 only after each write, and both finish.
- phase 2: ASYMMETRIC staleness — process 0 keeps its state DB (every task
  up to date locally), process 1 starts a fresh one (every task stale).
  Without the runner's cross-process consensus this deadlocks: process 1
  enters an action barrier process 0 never reaches. With it, both re-run
  everything and succeed.
- phase 3: a ONE-SIDED failure stops both processes.

Usage: python mp_torch_taskgraph_worker.py <pid> <nprocs> <port> <workdir>
"""

import os
import sys
from pathlib import Path

pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
workdir = Path(sys.argv[4])

os.environ["FMRP_DIST_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["FMRP_DIST_PROCS"] = str(nprocs)
os.environ["FMRP_DIST_PROC_ID"] = str(pid)
os.environ["FMRP_DIST_JAX"] = "0"

from fm_returnprediction_tpu_torch.parallel import distributed as dist  # noqa: E402

assert dist.initialize_distributed() == (pid, nprocs)
assert dist.initialize_distributed() == (pid, nprocs)   # idempotent


def sync(tag: str) -> None:
    dist.host_exchange().barrier(tag)


from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig  # noqa: E402
from fm_returnprediction_tpu_torch.taskgraph.engine import (  # noqa: E402
    PlainReporter,
    Task,
    TaskRunner,
    process_route,
)
from fm_returnprediction_tpu_torch.taskgraph.tasks import build_tasks  # noqa: E402

assert process_route() == "exchange"
raw, processed, out = workdir / "raw", workdir / "processed", workdir / "out"


def make_tasks():
    return build_tasks(synthetic=True, synthetic_config=SyntheticConfig(n_firms=30, n_months=30),
                       raw_dir=raw, processed_dir=processed, output_dir=out, device="cpu")


db = workdir / f"state_p{pid}.sqlite"
with TaskRunner(make_tasks(), db_path=db, reporter=PlainReporter()) as r:
    assert r.run(), "phase-1 DAG run failed"
assert (out / "table_1.pkl").exists() and (processed / "lewellen_panel.npz").exists()

sync("phase2_setup")
if pid == 1:  # asymmetric staleness: process 1 forgets everything
    db.unlink()
sync("phase2_go")

with TaskRunner(make_tasks(), db_path=db, reporter=PlainReporter()) as r2:
    assert r2.run(), "phase-2 (asymmetric staleness) run failed"
assert (out / "table_1.pkl").exists()

sync("phase3_go")


def flaky():
    if pid == 1:
        raise RuntimeError("injected one-sided failure")


with TaskRunner(
    [Task("flaky", [flaky]), Task("after", [lambda: None], task_dep=["flaky"])],
    db_path=workdir / f"state3_p{pid}.sqlite", reporter=PlainReporter(),
) as r3:
    assert r3.run() is False, "one-sided failure must fail the run everywhere"

loaded = [m for m in sys.modules if m == "jax" or m.startswith("fm_returnprediction_tpu.")]
assert not loaded, loaded
print(f"TG_OK {pid}", flush=True)
