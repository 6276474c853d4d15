"""Incremental task-graph engine: the orchestration layer.

The reference package's doit-style build engine, without doit:

- tasks with actions, ``file_dep``/``targets``/``task_dep``/``uptodate``
  semantics;
- persistent execution state in sqlite, keyed by file content hashes, so
  unchanged inputs skip work across processes;
- a green console reporter, plain under SLURM (escape codes pollute job
  logs);
- per-task wall-clock timing kept beside the state (``write_timing_log``);
- retries, per-action timeouts, ``keep_going`` and a failure ledger.

Python actions run in-process, so the CUDA context and the kernel
libraries load once across the tasks of a run.

Across processes (a run with ``FMRP_DIST_*`` or a ``torch.distributed``
group), the runner's staleness and success decisions are reduced over
every process, through the host exchange (``parallel.distributed``) when
it is up, else ``torch.distributed``. A run configured for more than one
process with neither up raises (``process_route``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sqlite3
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.resilience.errors import TaskTimeoutError

__all__ = ["DB_NAME", "Task", "TaskRunner", "Reporter", "GreenReporter", "PlainReporter",
           "default_reporter", "process_route", "write_timing_log"]

# The state DB's default name under BASE_DIR: the port's own, so the two
# packages' task states never mix (both write the same _data targets).
DB_NAME = ".fmrp-torch-task-db.sqlite"

Action = Union[str, Callable[[], object]]


@dataclasses.dataclass
class Task:
    """One node of the graph, doit's task contract: run ``actions`` when any ``file_dep`` content
    changed, a ``target`` is missing, an ``uptodate`` check fails, or the
    task has never run.

    Resilience knobs (``resilience`` layer):

    - ``retries``         — re-run the whole action list this many times
      after a failure (exponential backoff from ``retry_backoff_s``,
      deterministic jitter). A flaky WRDS pull costs a retry, not the run.
    - ``timeout_s``       — per-ACTION wall-clock budget. A stalled action
      fails with :class:`TaskTimeoutError` instead of hanging the graph
      (python actions run on a watchdogged worker thread that is abandoned
      on timeout; shell actions get ``subprocess`` timeouts).
    """

    name: str
    actions: Sequence[Action]
    file_dep: Sequence[Union[str, Path]] = ()
    targets: Sequence[Union[str, Path]] = ()
    task_dep: Sequence[str] = ()
    uptodate: Sequence[Callable[[], bool]] = ()
    doc: str = ""
    verbosity: int = 1
    retries: int = 0
    retry_backoff_s: float = 0.5
    timeout_s: Optional[float] = None


class Reporter:
    def start(self, task: Task) -> None: ...
    def skip(self, task: Task) -> None: ...
    def skip_failed(self, task: Task, dep: str) -> None: ...
    def retry(self, task: Task, attempt: int, err: Exception) -> None: ...
    def done(self, task: Task, seconds: float) -> None: ...
    def fail(self, task: Task, err: Exception) -> None: ...


class PlainReporter(Reporter):
    """No ANSI color: selected automatically under SLURM, where escape
    codes pollute job logs."""

    out = sys.stdout

    def start(self, task: Task) -> None:
        print(f".  {task.name}", file=self.out, flush=True)

    def skip(self, task: Task) -> None:
        print(f"-- {task.name} (up to date)", file=self.out, flush=True)

    def skip_failed(self, task: Task, dep: str) -> None:
        print(f"## {task.name} (skipped: dependency {dep} failed)",
              file=self.out, flush=True)

    def retry(self, task: Task, attempt: int, err: Exception) -> None:
        print(f"~~ {task.name} retry {attempt}: {err}",
              file=self.out, flush=True)

    def done(self, task: Task, seconds: float) -> None:
        print(f"   {task.name} ok [{seconds:.2f}s]", file=self.out, flush=True)

    def fail(self, task: Task, err: Exception) -> None:
        print(f"!! {task.name} FAILED: {err}", file=self.out, flush=True)


class GreenReporter(PlainReporter):
    """Green task lines."""

    GREEN, RED, RESET = "\033[32m", "\033[31m", "\033[0m"

    def start(self, task: Task) -> None:
        print(f"{self.GREEN}.  {task.name}{self.RESET}", file=self.out, flush=True)

    def skip(self, task: Task) -> None:
        print(
            f"{self.GREEN}-- {task.name} (up to date){self.RESET}",
            file=self.out,
            flush=True,
        )

    def done(self, task: Task, seconds: float) -> None:
        print(
            f"{self.GREEN}   {task.name} ok [{seconds:.2f}s]{self.RESET}",
            file=self.out,
            flush=True,
        )

    def fail(self, task: Task, err: Exception) -> None:
        print(f"{self.RED}!! {task.name} FAILED: {err}{self.RESET}", file=self.out)


def default_reporter() -> Reporter:
    """SLURM jobs get the plain reporter."""
    if os.environ.get("SLURM_JOB_ID"):
        return PlainReporter()
    return GreenReporter()


def _hash_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class TaskRunner:
    """Executes a task list in dependency order with sqlite-backed state.

    State schema: one row per (task, dep file) content hash plus a row per
    task recording success and timing. A task is up to date iff it succeeded
    before, every file_dep hash matches, every target exists, and every
    ``uptodate`` callable returns True.
    """

    def __init__(
        self,
        tasks: Iterable[Task],
        db_path: Optional[Union[str, Path]] = None,
        reporter: Optional[Reporter] = None,
    ):
        self.tasks: Dict[str, Task] = {}
        for t in tasks:
            if t.name in self.tasks:
                raise ValueError(f"Duplicate task name: {t.name}")
            self.tasks[t.name] = t
        if db_path is None:
            # Anchor at BASE_DIR, not cwd — stray sqlite state in whatever
            # directory the caller happens to run from is repo litter.
            from fm_returnprediction_tpu_torch.settings import config

            db_path = Path(config("BASE_DIR")) / DB_NAME
        self.db_path = Path(db_path)
        self.reporter = reporter or default_reporter()
        # Generous busy timeout + WAL so two concurrent runners sharing the
        # state DB queue behind each other instead of raising "database is
        # locked" and recording a spurious task failure.
        self._db = sqlite3.connect(self.db_path, timeout=60.0)
        try:
            self._db.execute("PRAGMA journal_mode=WAL")
        except sqlite3.DatabaseError:
            pass  # e.g. WAL unsupported on a network filesystem — fall back
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS dep_hash"
            " (task TEXT, path TEXT, hash TEXT, size INTEGER, mtime REAL,"
            "  PRIMARY KEY (task, path))"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS run_state"
            " (task TEXT PRIMARY KEY, ok INTEGER, seconds REAL, ts REAL)"
        )
        # the failure ledger ``keep_going`` runs append to: one row per
        # failed task (or dependency-skip), so a partially-failed graph is
        # inspectable after the fact instead of reconstructed from logs
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS failure_log"
            " (task TEXT, error TEXT, ts REAL)"
        )
        self._db.commit()
        self._closed = False

    # -- state ------------------------------------------------------------
    def _stored_deps(self, task: Task) -> Dict[str, tuple]:
        rows = self._db.execute(
            "SELECT path, hash, size, mtime FROM dep_hash WHERE task=?",
            (task.name,),
        ).fetchall()
        return {path: (h, size, mtime) for path, h, size, mtime in rows}

    def _record_success(self, task: Task, seconds: float) -> None:
        # a success heals the ledger: failure rows describe the CURRENT
        # state of the graph, not dead history (history is the run log)
        self._db.execute("DELETE FROM failure_log WHERE task=?", (task.name,))
        self._db.execute("DELETE FROM dep_hash WHERE task=?", (task.name,))
        for dep in task.file_dep:
            p = Path(dep)
            if p.exists():
                st = p.stat()
                self._db.execute(
                    "INSERT OR REPLACE INTO dep_hash VALUES (?,?,?,?,?)",
                    (task.name, str(p), _hash_file(p), st.st_size, st.st_mtime),
                )
        self._db.execute(
            "INSERT OR REPLACE INTO run_state VALUES (?,?,?,?)",
            (task.name, 1, seconds, time.time()),
        )
        self._db.commit()

    def is_up_to_date(self, task: Task) -> bool:
        row = self._db.execute(
            "SELECT ok FROM run_state WHERE task=?", (task.name,)
        ).fetchone()
        if not row or not row[0]:
            return False
        for tgt in task.targets:
            if not Path(tgt).exists():
                return False
        stored = self._stored_deps(task)
        for dep in task.file_dep:
            p = Path(dep)
            if not p.exists() or str(p) not in stored:
                return False
            h, size, mtime = stored[str(p)]
            st = p.stat()
            if st.st_size == size and st.st_mtime == mtime:
                continue  # metadata unchanged → trust the stored hash
            if h != _hash_file(p):
                return False
            # Content identical but metadata drifted (touch/copy): refresh
            # the metadata so the next check short-circuits again.
            self._db.execute(
                "UPDATE dep_hash SET size=?, mtime=? WHERE task=? AND path=?",
                (st.st_size, st.st_mtime, task.name, str(p)),
            )
            self._db.commit()
        for check in task.uptodate:
            if not check():
                return False
        # A task with nothing to compare is always stale (doit semantics for
        # bare tasks) unless an uptodate check said otherwise.
        if not task.targets and not list(task.file_dep) and not task.uptodate:
            return False
        return True

    def forget(self, names: Optional[Sequence[str]] = None) -> None:
        """Drop recorded state (doit ``forget``) for ``names`` or all —
        including the failure ledger, so a forgotten task re-runs with a
        clean record."""
        for name in names or list(self.tasks):
            self._db.execute("DELETE FROM dep_hash WHERE task=?", (name,))
            self._db.execute("DELETE FROM run_state WHERE task=?", (name,))
            self._db.execute("DELETE FROM failure_log WHERE task=?", (name,))
        self._db.commit()

    def failures(self) -> List[dict]:
        """The recorded failure ledger, oldest first: one entry per failed
        task or dependency-skip (``{"task", "error", "ts"}``)."""
        rows = self._db.execute(
            "SELECT task, error, ts FROM failure_log ORDER BY ts, rowid"
        ).fetchall()
        return [{"task": t, "error": e, "ts": ts} for t, e, ts in rows]

    def timings(self) -> Dict[str, float]:
        """Last SUCCESSFUL wall-clock seconds per task."""
        rows = self._db.execute(
            "SELECT task, seconds FROM run_state WHERE seconds IS NOT NULL"
        ).fetchall()
        return dict(rows)

    # -- execution --------------------------------------------------------
    def _toposort(self, names: Sequence[str]) -> List[str]:
        order: List[str] = []
        seen: Dict[str, int] = {}  # 0=visiting, 1=done

        def visit(name: str) -> None:
            if name not in self.tasks:
                raise KeyError(f"Unknown task: {name}")
            state = seen.get(name)
            if state == 1:
                return
            if state == 0:
                raise ValueError(f"Task dependency cycle at {name}")
            seen[name] = 0
            for dep in self.tasks[name].task_dep:
                visit(dep)
            seen[name] = 1
            order.append(name)

        for name in names:
            visit(name)
        return order

    @staticmethod
    def _consensus(flag: bool, reduce) -> bool:
        """Cross-process reduction of a local boolean; identity in a run of
        one process.

        Two uses keep the engine's collective sequence aligned across
        processes:

        - STALENESS (``reduce=np.any``): the skip decision is per-process
          (local state DB, local clocks), but task actions contain
          cross-process BARRIERS (``tasks._primary_writes``) — if one
          process skips a task another runs, the runner deadlocks inside
          the action. If ANY process finds a task stale, everyone runs it
          (writes are process-0-gated, so redundant runs are compute-only).
        - SUCCESS (``reduce=np.all``): a one-sided failure must stop all
          processes together — the failed process makes no further
          collective calls, so survivors marching into the next staleness
          gather would hang there, masking the real traceback.
        """
        import numpy as _np

        route = process_route()
        if route is None:
            return flag
        if route == "exchange":
            from fm_returnprediction_tpu_torch.parallel import distributed as _dist

            flags = _dist.host_exchange().allgather_obj(bool(flag))
        else:
            import torch.distributed as _tdist

            flags = [None] * _tdist.get_world_size()
            _tdist.all_gather_object(flags, bool(flag))
        return bool(reduce(_np.asarray(flags)))

    # -- action execution (retry / timeout / fault isolation) -------------

    def _run_action(self, task: Task, action: Action) -> None:
        """One action under the task's ``timeout_s`` budget. The fault site
        lets the chaos harness inject failures/stalls per task name."""
        from fm_returnprediction_tpu_torch.resilience.faults import fault_site

        fault_site(f"taskgraph.{task.name}")
        if isinstance(action, str):
            try:
                subprocess.run(
                    action, shell=True, check=True, timeout=task.timeout_s
                )
            except subprocess.TimeoutExpired as exc:
                raise TaskTimeoutError(
                    f"task {task.name!r} shell action exceeded "
                    f"{task.timeout_s}s"
                ) from exc
            return
        if task.timeout_s is None:
            action()
            return
        # Python actions cannot be killed; run on a daemon worker and
        # ABANDON it on timeout — the graph fails the node and moves on
        # (the documented trade: a leaked sleeping thread beats a hung
        # build). Callers whose actions must run on the main thread
        # (signal handlers) should not set timeout_s.
        result: Dict[str, object] = {}
        # the worker thread does not inherit this thread's context — hand
        # the task span across explicitly so everything the action records
        # (pipeline stages, retries) stays in the task's trace
        parent = telemetry.capture()

        def target() -> None:
            try:
                with telemetry.attach(parent):
                    result["ok"] = action()
            except BaseException as exc:  # noqa: BLE001 — relayed below
                result["err"] = exc

        worker = threading.Thread(
            target=target, daemon=True, name=f"fmrp-task-{task.name}"
        )
        worker.start()
        worker.join(task.timeout_s)
        if worker.is_alive():
            telemetry.event(
                "task.timeout", cat="taskgraph",
                task=task.name, timeout_s=task.timeout_s,
            )
            # flight recorder: freeze the last spans/events + cost ledger
            # at the moment the watchdog fired (no-op without a trace dir)
            telemetry.dump_flight(f"task.timeout:{task.name}")
            raise TaskTimeoutError(
                f"task {task.name!r} action exceeded {task.timeout_s}s "
                "(worker abandoned)"
            )
        if "err" in result:
            raise result["err"]  # type: ignore[misc]

    def _execute_actions(self, task: Task) -> None:
        """The whole action list, re-run up to ``task.retries`` extra times
        on failure (shared backoff policy, deterministic jitter; retries
        restart from the FIRST action — actions are assumed idempotent,
        which the file_dep/target contract already requires)."""
        from fm_returnprediction_tpu_torch.resilience.retry import RetryPolicy, call_with_retry

        def once() -> None:
            for action in task.actions:
                self._run_action(task, action)

        if task.retries <= 0:
            once()  # no wrapper: the original traceback stays primary
            return
        call_with_retry(
            once,
            RetryPolicy(
                max_attempts=task.retries + 1,
                backoff_s=task.retry_backoff_s,
                retry_on=(Exception,),
            ),
            label=task.name,
            on_retry=lambda attempt, err: self.reporter.retry(
                task, attempt, err
            ),
        )

    def _record_failure(self, task: Task, error: str, ran: bool = True) -> None:
        """Append to the failure ledger; a task that actually RAN is also
        marked stale (PRESERVING the last successful timing — the timing
        log is the wall-clock record, not the failure log). A dependency-
        skip leaves run_state untouched: the task itself never executed."""
        if ran:
            self._db.execute(
                "INSERT INTO run_state VALUES (?,0,NULL,?)"
                " ON CONFLICT(task) DO UPDATE SET ok=0, ts=excluded.ts",
                (task.name, time.time()),
            )
        self._db.execute(
            "INSERT INTO failure_log VALUES (?,?,?)",
            (task.name, error, time.time()),
        )
        self._db.commit()
        # the structured twin of the sqlite ledger row: the trace and the
        # failure_log agree
        telemetry.event(
            "task.failure", cat="taskgraph",
            task=task.name, error=error, ran=ran,
        )
        if ran:  # dependency-skips carry no new evidence worth a dump
            telemetry.dump_flight(f"task.failure:{task.name}")

    def run(
        self,
        names: Optional[Sequence[str]] = None,
        force: bool = False,
        keep_going: bool = False,
    ) -> bool:
        """Run ``names`` (default: all tasks) and their deps. Returns True
        if everything succeeded.

        ``keep_going`` (make's ``-k``): a failed node fails its DEPENDENT
        subgraph — dependents are marked skipped in the failure ledger —
        but independent subgraphs keep running, so one flaky stage does
        not strand unrelated work. Without it, the first failure halts
        the run (prior behavior).

        An abort (KeyboardInterrupt/SystemExit) is recorded like a
        failure, then the sqlite connection is CLOSED before re-raising —
        an interrupted run must not leave a locked state DB behind.
        """
        import numpy as _np

        order = self._toposort(list(names or self.tasks))
        ok_all = True
        dead: set = set()  # failed, or skipped because a dependency failed
        for name in order:
            task = self.tasks[name]
            if dead:
                bad = next((d for d in task.task_dep if d in dead), None)
                if bad is not None:
                    self.reporter.skip_failed(task, bad)
                    self._record_failure(
                        task, f"skipped: dependency {bad!r} failed", ran=False
                    )
                    dead.add(name)
                    continue
            stale = force or not self.is_up_to_date(task)
            if not self._consensus(stale, _np.any):
                self.reporter.skip(task)
                telemetry.event(
                    "task.skip", cat="taskgraph", task=name,
                    reason="up-to-date",
                )
                continue
            self.reporter.start(task)
            start = time.perf_counter()
            err: Optional[BaseException] = None
            try:
                # one span per executed task: retries (retry:<name> child
                # spans), the watchdogged worker, and everything the action
                # itself records nest under it in the exported trace
                with telemetry.span(
                    f"task:{name}", cat="task", task=name,
                    keep_going=keep_going,
                ):
                    self._execute_actions(task)
            except BaseException as exc:  # noqa: BLE001 — recorded below
                err = exc
            if not self._consensus(err is None, _np.all):
                if err is None:  # a PEER failed; this process's task was fine
                    err = RuntimeError(
                        "task failed on another process (see its log)"
                    )
                self.reporter.fail(task, err)
                self._record_failure(task, repr(err))
                if isinstance(err, (KeyboardInterrupt, SystemExit)):
                    self.close()
                    raise err
                if not keep_going:
                    return False
                ok_all = False
                dead.add(name)
                continue
            seconds = time.perf_counter() - start
            self._record_success(task, seconds)
            self.reporter.done(task, seconds)
        return ok_all

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._db.close()

    def __enter__(self) -> "TaskRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def process_route() -> Optional[str]:
    """How this process reaches the others of its run: ``"exchange"`` (the
    host exchange of ``parallel.distributed``), ``"torch"`` (a
    ``torch.distributed`` group of more than one rank), or None in a run of
    one process. Raises ``RuntimeError`` when ``FMRP_DIST_*`` configures
    more than one process but neither route is up: the collectives of the
    task graph would otherwise silently do nothing."""
    from fm_returnprediction_tpu_torch.parallel import distributed as _dist
    from fm_returnprediction_tpu_torch.parallel.multihost import distributed_client_active

    if _dist.host_exchange() is not None:
        return "exchange"
    if distributed_client_active():
        import torch.distributed as _tdist

        return "torch" if _tdist.get_world_size() > 1 else None
    if _dist.process_count() > 1:
        raise RuntimeError(
            f"this run is configured for {_dist.process_count()} processes "
            "(FMRP_DIST_*) but neither the host exchange "
            "(parallel.distributed.initialize_distributed) nor a "
            "torch.distributed group is up")
    return None


def write_timing_log(runner: TaskRunner, path: Union[str, Path]) -> None:
    """Dump the per-task timings (``TaskRunner.timings``) as JSON."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(runner.timings(), f, indent=2, sort_keys=True)
