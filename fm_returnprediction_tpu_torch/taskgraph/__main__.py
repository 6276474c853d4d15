"""Task-graph command line, the ``doit`` command surface.

    python -m fm_returnprediction_tpu_torch.taskgraph                 # run all
    python -m fm_returnprediction_tpu_torch.taskgraph reports          # run up to a task
    python -m fm_returnprediction_tpu_torch.taskgraph --list           # show tasks
    python -m fm_returnprediction_tpu_torch.taskgraph --forget         # drop state
    python -m fm_returnprediction_tpu_torch.taskgraph --synthetic      # synthetic backend
    python -m fm_returnprediction_tpu_torch.taskgraph --device cpu     # on the CPU

The tasks run on the GPU unless ``--device cpu`` (or ``BACKEND=cpu``) asks
for the CPU; without a GPU the command raises before any task runs. The
state DB defaults to ``BASE_DIR/.fmrp-torch-task-db.sqlite``, the port's
own. A failed task, and a failed ``--fleet-size`` smoke, exit non-zero.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from fm_returnprediction_tpu_torch.settings import apply_backend, config
from fm_returnprediction_tpu_torch.taskgraph.engine import DB_NAME, TaskRunner, write_timing_log
from fm_returnprediction_tpu_torch.taskgraph.tasks import build_notebook_tasks, build_tasks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="fm_returnprediction_tpu_torch.taskgraph")
    parser.add_argument("tasks", nargs="*", help="tasks to run (default: all)")
    parser.add_argument("--list", action="store_true", help="list tasks and exit")
    parser.add_argument("--forget", action="store_true", help="drop recorded state")
    parser.add_argument("--force", action="store_true", help="ignore up-to-date state")
    parser.add_argument("--keep-going", action="store_true",
                        help="continue independent subgraphs after a failure "
                             "(failures recorded in the state DB)")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic backend instead of WRDS")
    parser.add_argument("--specgrid-cells", type=int, default=None,
                        metavar="N",
                        help="scale the specgrid task's sweep to at least "
                             "N cells (bootstrap-draw dimension grows; "
                             "tiles stream so memory stays bounded)")
    parser.add_argument("--specgrid-sink", default=None,
                        choices=["frame", "topk", "summary", "parquet"],
                        help="specgrid task streaming sink (default "
                             "follows FMRP_SPECGRID_SINK, else the full "
                             "tidy frame)")
    parser.add_argument("--specgrid-estimator", default=None,
                        metavar="SPEC",
                        help="run the specgrid sweep under an estimator "
                             "cell instead of OLS@NW — grammar "
                             "'fwl:c1+c2[@se]' | 'absorb:fe1+fe2' | "
                             "'iv:endog~z1+z2' | 'pooled[:se]' (default "
                             "follows FMRP_SPECGRID_ESTIMATOR; Table 2 "
                             "and the figure keep rejecting non-OLS "
                             "loudly)")
    parser.add_argument("--backtest-schemes", default=None, metavar="LIST",
                        help="backtest task estimation-path schemes, a "
                             "comma list like 'expanding,rolling120' "
                             "(default follows FMRP_BACKTEST_SCHEMES)")
    parser.add_argument("--backtest-route", default=None,
                        choices=["auto", "scan", "refit"],
                        help="backtest coefficient-path route: prefix-sum "
                             "scan program or the per-origin full-refit "
                             "differential oracle (default follows "
                             "FMRP_BACKTEST_ROUTE)")
    parser.add_argument("--backtest-quantiles", type=int, default=None,
                        metavar="D",
                        help="backtest portfolio sort buckets, >= 2 "
                             "(default follows FMRP_BACKTEST_QUANTILES)")
    parser.add_argument("--backtest-sink", default=None,
                        choices=["frame", "topk", "summary", "parquet",
                                 "metrics"],
                        help="backtest task streaming sink (default "
                             "follows FMRP_BACKTEST_SINK, else the full "
                             "per-cell frame)")
    parser.add_argument("--notebooks", action="store_true",
                        help="include the notebook conversion/execution tasks")
    parser.add_argument("--db", default=None,
                        help=f"state db path (default BASE_DIR/{DB_NAME})")
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="compute device of the tasks (default follows "
                             "BACKEND, normally cuda; raises without a "
                             "GPU); takes the place of the reference's "
                             "--backend")
    parser.add_argument("--trace-dir", default=None,
                        help="arm telemetry: export task/stage spans to "
                             "events.jsonl + trace.json in this directory "
                             "(default follows FMRP_TRACE_DIR)")
    parser.add_argument("--profile-dir", default=None,
                        help="capture a torch.profiler trace of the run "
                             "(CPU and, on the card, CUDA activities) into "
                             "this directory as profile_trace.json; host "
                             "spans name their intervals in it")
    parser.add_argument("--registry-dir", default=None,
                        help="arm the registry at this root for every "
                             "task (kernel libraries and fitted artifacts "
                             "are fetched instead of rebuilt); default "
                             "follows FMRP_REGISTRY_DIR")
    parser.add_argument("--fleet-size", type=int, default=None, metavar="N",
                        help="after the DAG completes, stand up an "
                             "N-replica serving fleet on the produced "
                             "serving_state.npz and run the admission-"
                             "controlled query smoke (default follows "
                             "FMRP_FLEET_SIZE when that is set; "
                             "FMRP_FLEET_RATE/_BURST/_SHED_OCCUPANCY "
                             "shape admission, FMRP_FLEET_JOURNAL arms "
                             "the request journal); a failed smoke exits "
                             "non-zero")
    parser.add_argument("--replica-mode", choices=("thread", "process"),
                        default=None,
                        help="fleet smoke replica boundary: in-process "
                             "threads or spawned child processes behind "
                             "the socket or shared-memory transport "
                             "(FMRP_FLEET_TRANSPORT); default follows "
                             "FMRP_FLEET_REPLICA_MODE (thread)")
    args = parser.parse_args(argv)

    from fm_returnprediction_tpu_torch.device import resolve_device
    from fm_returnprediction_tpu_torch.parallel.distributed import initialize_distributed
    from fm_returnprediction_tpu_torch.parallel.multihost import initialize_multihost

    # join a run across processes when FMRP_DIST_* is set (host exchange
    # and telemetry identity), and the torch.distributed group when
    # FMRP_MULTIHOST=1; no-ops otherwise
    initialize_distributed()
    initialize_multihost()
    # the device every task runs on; a missing GPU raises here, before any
    # task has run
    device = resolve_device(apply_backend(args.device))

    tasks = build_tasks(synthetic=args.synthetic,
                        specgrid_cells=args.specgrid_cells,
                        specgrid_sink=args.specgrid_sink,
                        specgrid_estimator=args.specgrid_estimator,
                        backtest_schemes=args.backtest_schemes,
                        backtest_route=args.backtest_route,
                        backtest_quantiles=args.backtest_quantiles,
                        backtest_sink=args.backtest_sink,
                        device=device)
    if args.notebooks:
        tasks += build_notebook_tasks()
    db = args.db or Path(config("BASE_DIR")) / DB_NAME

    from contextlib import ExitStack

    from fm_returnprediction_tpu_torch import telemetry
    from fm_returnprediction_tpu_torch.registry.store import using_registry

    with ExitStack() as stack:
        stack.enter_context(using_registry(args.registry_dir))
        stack.enter_context(telemetry.tracing(args.trace_dir))
        stack.enter_context(telemetry.profiling(args.profile_dir, device=device))
        runner = stack.enter_context(TaskRunner(tasks, db_path=db))
        if args.list:
            for t in tasks:
                state = "up-to-date" if runner.is_up_to_date(t) else "stale"
                print(f"{t.name:<14} [{state}] {t.doc}")
            return 0
        if args.forget:
            runner.forget(args.tasks or None)
            print("state forgotten")
            return 0
        import time

        t_run = time.time()
        ok = runner.run(args.tasks or None, force=args.force,
                        keep_going=args.keep_going)
        if not ok and args.keep_going:
            # THIS run's failures only — the ledger also holds rows from
            # prior still-unhealed runs
            for entry in runner.failures():
                if entry["ts"] >= t_run:
                    print(f"FAILED {entry['task']}: {entry['error']}",
                          file=sys.stderr)
        write_timing_log(runner, Path(config("OUTPUT_DIR")) / "task_timings.json")
        import os as _os

        fleet_size = args.fleet_size
        if fleet_size is None and _os.environ.get("FMRP_FLEET_SIZE"):
            fleet_size = int(_os.environ["FMRP_FLEET_SIZE"])
        if ok and fleet_size:
            import json as _json

            from fm_returnprediction_tpu_torch.serving.fleet import fleet_smoke

            state_path = Path(config("PROCESSED_DATA_DIR")) / "serving_state.npz"
            if not state_path.exists():
                print(f"fleet smoke skipped: {state_path} not built "
                      "(run the serve_state task)", file=sys.stderr)
            else:
                # unlike the reference, a failed smoke is not swallowed:
                # the exception ends the command with a non-zero exit
                smoke = fleet_smoke(state_path, fleet_size,
                                    registry_dir=args.registry_dir,
                                    replica_mode=args.replica_mode, device=device)
                print("serving fleet smoke: " + _json.dumps(smoke, sort_keys=True))
        return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
