"""Request/response front end for online expected-return queries.

Wires a fitted :class:`~fm_returnprediction_tpu_torch.serving.state.ServingState`
to the bucketed executor and the microbatcher, and owns the service-level
instrumentation: warm-up is a named stage, and ``stats()`` merges the
batcher's queue metrics (p50/p99 latency, batch occupancy, rejects) with
the executor's program counters (hits/misses/compiles) and the qps.

Quickstart (build the state → warm → query)::

    state = build_serving_state_from_panel(panel, masks["All stocks"])
    with ERService(state) as svc:            # on the GPU; warm=True captures
        er = svc.query("2001-06-30", x_row)  # every bucket's CUDA graph
        print(svc.report())

    ERService(state, device="cpu")           # eager buckets on the CPU

``device=None`` means the GPU and raises without one: there is no CPU
fallback.

Fault tolerance:

- the service holds a LAST-KNOWN-GOOD state: :meth:`ingest_month` passes
  the offered month through the ``serving.ingest`` fault site, validates
  it (``serving.ingest.validate_cross_section``), appends it by the
  incremental merge, and only then swaps the new state in behind a freshly
  WARMED executor (its graphs captured before publication). Any failure
  (NaN flood, shape mismatch, merge divergence beyond tolerance, an
  exception anywhere in the ingest) QUARANTINES the month, and the service
  keeps quoting from the previous state (``degraded`` and
  ``quarantined_months`` in ``stats()``). A later successful re-ingest of
  a quarantined month clears it.
- ``dispatch_timeout_s`` arms the executor's per-dispatch watchdog: a
  stalled runner fails its own batch (``DispatchTimeoutError`` on its
  futures) instead of hanging the microbatcher; later queries are
  unaffected.

Both default OFF; with no ``FaultPlan`` installed the added cost is one
module-global read per dispatch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.resilience.errors import IngestRejectedError
from fm_returnprediction_tpu_torch.resilience.faults import fault_site
from fm_returnprediction_tpu_torch.serving.batcher import MicroBatcher
from fm_returnprediction_tpu_torch.serving.executor import BucketedExecutor
from fm_returnprediction_tpu_torch.utils.timing import StageTimer

__all__ = ["ERService"]


class ERService:
    """Online E[r] query service over a fitted ``ServingState``."""

    def __init__(
        self,
        state,
        max_batch: int = 256,
        max_latency_ms: float = 2.0,
        max_queue: int = 1024,
        min_bucket: int = 1,
        warm: bool = True,
        auto_flush: bool = True,
        dispatch_timeout_s: Optional[float] = None,
        merge_tolerance: Optional[float] = None,
        slos=None,
        metric_labels: Optional[dict] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.state = state
        self.timer = StageTimer(self.device)
        # extra labels stamped on every metric family this service's
        # batcher and executor register (``replica="rN"`` splits /metrics
        # per replica); empty = unlabeled families
        self._metric_labels = dict(metric_labels or {})
        # SLO monitor (telemetry.slo): explicit objectives, else the
        # FMRP_SLO_* env knobs; None when neither is set — the monitor is
        # pure observation, so arming it changes no serving behavior
        from fm_returnprediction_tpu_torch.telemetry import slo as _slo

        objectives = tuple(slos) if slos is not None else _slo.slos_from_env()
        self.slo: Optional[_slo.SloMonitor] = (
            _slo.SloMonitor(objectives, window_s=_slo.env_window_s())
            if objectives else None
        )
        self._max_queue = max_queue
        self._max_batch = max_batch
        self._min_bucket = min_bucket
        self._dispatch_timeout_s = dispatch_timeout_s
        # merge-divergence gate for re-ingest of the current last month:
        # a merged cross-section that moves the month's coefficients by
        # more than tolerance*(1+|old|) per entry is quarantined as a
        # data fault. None disables (legitimate late data can move a thin
        # month's fit a lot; the knob is for callers who know their feed).
        self.merge_tolerance = merge_tolerance
        # stage names are TOP-LEVEL on this timer (no "/": StageTimer's
        # nesting rule)
        with self.timer.stage("serving_build_executor"):
            self.executor = self._build_executor(state)
        if warm:
            with self.timer.stage("serving_warmup"):
                self.executor.warmup()
        self.batcher = MicroBatcher(
            self._dispatch,
            max_batch=max_batch,
            max_latency_ms=max_latency_ms,
            max_queue=max_queue,
            auto_flush=auto_flush,
            n_predictors=state.n_predictors,
            min_bucket=min_bucket,
            observer=self._observe_request if self.slo is not None else None,
            metric_labels=self._metric_labels,
        )
        self._quarantined: dict = {}  # month label → rejection reason
        self._n_ingested = 0
        self._n_ingest_failed = 0
        # the guard ledger: every contract violation an ingest attempt
        # tripped (named rules, ``guard.contracts``)
        from fm_returnprediction_tpu_torch.guard.contracts import AuditRecord

        self.audit = AuditRecord()
        # Executor counters must survive ingest swaps (each ingest
        # publishes a FRESH executor): retired executors stay in a short
        # deque and are summed LIVE in stats() — an in-flight batch still
        # dispatching on one keeps incrementing a counted object — and
        # only fold into the plain-int totals once enough swaps have
        # passed that nothing can still be running on them. The lock makes
        # a swap atomic against a concurrent stats() read (no double
        # count mid-swap).
        self._swap_lock = threading.Lock()
        self._retired: deque = deque()
        self._exec_prior = {"hits": 0, "misses": 0, "compiles": 0,
                            "timeouts": 0}
        self._t0 = time.perf_counter()

    def _build_executor(self, state) -> BucketedExecutor:
        return BucketedExecutor(
            state,
            max_batch=self._max_batch,
            min_bucket=self._min_bucket,
            dispatch_timeout_s=self._dispatch_timeout_s,
            metric_labels=self._metric_labels,
            device=self.device,
        )

    def _observe_request(self, latency_s, ok, queue_depth) -> None:
        """Batcher outcome hook → SLO monitor (see ``MicroBatcher``'s
        ``observer`` contract)."""
        self.slo.observe(latency_s, ok=ok)
        if queue_depth is not None and self._max_queue:
            self.slo.observe_queue(queue_depth / self._max_queue)

    def _dispatch(self, month_idx, x, valid) -> np.ndarray:
        # one indirection instead of binding ``executor.run`` into the
        # batcher: ingest_month swaps ``self.executor`` atomically and
        # in-flight batches finish on whichever executor they started with
        # (append-only states keep old month slots valid in new ones)
        return self.executor.run(month_idx, x, valid)

    # -- queries -----------------------------------------------------------

    def submit(self, month, x) -> Future:
        """Async query: one firm's predictor row for one month. The month is
        an int T-slot or a datetime-like in the state's vocabulary; raises
        ``KeyError`` for unknown months, :class:`QueueFullError` under
        backpressure."""
        return self.batcher.submit(self.state.month_index(month), x)

    def submit_many(self, reqs) -> list:
        """Bulk :meth:`submit`: ``reqs`` = [(month, x), ...] → one
        ``("ok", Future)`` / ``("err", exception)`` per request (unknown
        months land as ``("err", KeyError)``), the enqueue paid under one
        batcher lock (``MicroBatcher.submit_many``)."""
        resolved = []
        errs: dict = {}
        for i, (month, x) in enumerate(reqs):
            try:
                resolved.append((self.state.month_index(month), x))
            except Exception as exc:  # noqa: BLE001 — per-row semantics
                errs[i] = exc
        batched = self.batcher.submit_many(resolved)
        out: list = []
        it = iter(batched)
        for i in range(len(reqs)):
            if i in errs:
                out.append(("err", errs[i]))
            else:
                out.append(next(it))
        return out

    def query(self, month, x, timeout: Optional[float] = 30.0) -> float:
        """Blocking single query → E[r] (NaN when unavailable: incomplete
        predictors or a month with no lagged coefficient mean)."""
        return self.submit(month, x).result(timeout=timeout)

    def query_many(
        self, months: Sequence, xs, timeout: Optional[float] = 30.0
    ) -> np.ndarray:
        """Submit a stream of single-row queries, gather all results (the
        batcher coalesces them into bucket batches underneath)."""
        futures = [self.submit(m, x) for m, x in zip(months, xs)]
        return np.asarray([f.result(timeout=timeout) for f in futures])

    # -- incremental ingest with quarantine --------------------------------

    @staticmethod
    def _month_key(month) -> str:
        try:
            return str(np.datetime64(month, "ns"))
        except (ValueError, TypeError):
            return str(month)

    def ingest_month(self, y_new, x_new, mask_new, month) -> bool:
        """Append (or merge) one month's cross-section; ``True`` on success.

        On ANY failure the month is quarantined — recorded with its
        rejection reason, counted in ``stats()`` — and the service keeps
        quoting from the last-known-good state. Nothing the caller feeds
        this method can take the service down; the worst outcome is a
        stale-by-one-month quote stream, disclosed via ``degraded``.

        The swap is crash-consistent and warm: the new state's executor is
        built and fully warmed (its graphs captured) BEFORE publication, so
        the first query after an ingest pays no build, and a failure during
        warm-up leaves the old state serving. The month's statistics and
        solve run on the service's device.
        """
        key = self._month_key(month)
        from fm_returnprediction_tpu_torch.serving.ingest import (
            ingest_month as _ingest,
            validate_cross_section,
        )

        try:
            # chaos hook: a poisoned feed mutates the payload HERE, before
            # validation — the quarantine path must catch what it does
            y_new, x_new, mask_new = fault_site(
                "serving.ingest", payload=(y_new, x_new, mask_new)
            )
            y, x, mask = validate_cross_section(
                self.state, y_new, x_new, mask_new, month=month,
                audit=self.audit,
            )
            with self.timer.stage("serving_ingest"):
                new_state = _ingest(self.state, y, x, mask, month, device=self.device)
            merged = new_state.n_months == self.state.n_months
            if merged and self.merge_tolerance is not None:
                old_row, new_row = self.state.coef[-1], new_state.coef[-1]
                both = np.isfinite(old_row) & np.isfinite(new_row)
                moved = np.abs(new_row - old_row)[both]
                bound = self.merge_tolerance * (1.0 + np.abs(old_row)[both])
                if moved.size and (moved > bound).any():
                    raise IngestRejectedError(
                        f"merge divergence: coefficient moved "
                        f"{moved.max():.3g} > tolerance"
                    )
            with self.timer.stage("serving_ingest_warmup"):
                new_exec = self._build_executor(new_state)
                new_exec.warmup()
        except Exception as exc:  # noqa: BLE001 — quarantine, keep serving
            self._quarantined[key] = repr(exc)[:300]
            self._n_ingest_failed += 1
            telemetry.registry().counter(
                "fmrp_serving_quarantines_total",
                help="ingest months quarantined (service kept quoting "
                     "from last-known-good)",
            ).inc()
            telemetry.event(
                "serving.quarantine", cat="serving",
                month=key, error=repr(exc)[:200],
            )
            # flight recorder: the last N spans/events + the cost ledger,
            # frozen at the moment the month went bad (no-op unless a
            # trace dir is armed)
            telemetry.dump_flight(f"serving.quarantine:{key}")
            return False
        self._publish(new_state, new_exec)
        self._n_ingested += 1
        # a successful re-ingest of a quarantined month heals it
        self._quarantined.pop(key, None)
        return True

    def _publish(self, new_state, new_exec) -> None:
        """Atomically flip to an already-WARMED executor + state pair.

        Attribute assignment is atomic under the GIL, and append-only
        month slots mean an in-flight request resolved on the old state
        dispatches correctly on either executor. The old executor retires
        into a short deque so its counters keep aggregating until nothing
        can still be running on it."""
        with self._swap_lock:
            self._retired.append(self.executor)
            while len(self._retired) > 4:  # nothing in-flight survives 4 swaps
                dead = self._retired.popleft()
                self._exec_prior["hits"] += dead.hits
                self._exec_prior["misses"] += dead.misses
                self._exec_prior["compiles"] += dead.compiles
                self._exec_prior["timeouts"] += dead.timeouts
            self.state = new_state
            self.executor = new_exec

    # -- versioned state rollover (two phases: prepare, then commit) --------

    def prepare_state(self, new_state):
        """Phase 1 of a zero-downtime state rollover: build and fully WARM
        an executor for ``new_state`` without publishing anything. The
        service keeps quoting the current version throughout; a failure
        here leaves it untouched. Returns the opaque prepared pair for
        :meth:`commit_state`."""
        with self.timer.stage("serving_prepare_state"):
            new_exec = self._build_executor(new_state)
            new_exec.warmup()
        return (new_state, new_exec)

    def commit_state(self, prepared) -> None:
        """Phase 2: atomically flip to a :meth:`prepare_state` result:
        one attribute swap under the lock (the captures were paid in
        phase 1)."""
        new_state, new_exec = prepared
        self._publish(new_state, new_exec)

    def swap_state(self, new_state) -> None:
        """Prepare then commit: publish an externally built state (a
        monthly batch refit) behind a warmed executor."""
        self.commit_state(self.prepare_state(new_state))

    def kill(self, reason: str = "replica killed") -> int:
        """Abrupt death (the failover and chaos path): every queued request
        FAILS with :class:`ReplicaDeadError` and the service stops
        accepting work. No drain, no flush; contrast :meth:`close`. Returns
        the number of queued requests failed."""
        from fm_returnprediction_tpu_torch.resilience.errors import ReplicaDeadError

        stranded = self.batcher.abort(ReplicaDeadError(reason))
        server = getattr(self, "_metrics_server", None)
        if server is not None:
            server.shutdown()
            server.server_close()
            self._metrics_server = None
        return stranded

    def release(self, timeout: float = 5.0) -> None:
        """Free what a killed or closed service holds on the device: its
        executors' bucket graphs, their static buffers and pinned staging,
        and the state pushed to the card (the fleet calls it when a
        replica leaves, and as the fence of ``hard_crash``). Waits up to
        ``timeout`` for the flusher thread (a batch mid-dispatch finishes
        first), then releases every executor, the retired ones included.
        Counters and ``stats()`` keep working; queries do not."""
        thread = self.batcher._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=timeout)
        with self._swap_lock:
            executors = [*self._retired, self.executor]
        for ex in executors:
            ex.release()

    @property
    def degraded(self) -> bool:
        """True while any quarantined month is outstanding — the quote
        stream is live but missing data it was offered."""
        return bool(self._quarantined)

    def quarantined_months(self) -> dict:
        """month label → rejection reason, for every outstanding
        quarantine."""
        return dict(self._quarantined)

    # -- instrumentation ---------------------------------------------------

    def stats(self) -> dict:
        """One flat dict: queue metrics + bucket program counters + qps +
        degraded-mode visibility."""
        out = self.batcher.stats()
        elapsed = time.perf_counter() - self._t0
        with self._swap_lock:
            live = [*self._retired, self.executor]
            tot = {
                k: self._exec_prior[k] + sum(getattr(ex, a) for ex in live)
                for k, a in (("hits", "hits"), ("misses", "misses"),
                             ("compiles", "compiles"),
                             ("timeouts", "timeouts"))
            }
            buckets = len(self.executor.buckets())
        out.update(
            qps=(out["n_done"] / elapsed) if elapsed > 0 else 0.0,
            executable_cache_hits=tot["hits"],
            executable_cache_misses=tot["misses"],
            executable_compiles=tot["compiles"],
            buckets_compiled=buckets,
            warmup_s=self.timer.durations.get("serving_warmup"),
            degraded=self.degraded,
            quarantined_months=sorted(self._quarantined),
            n_ingested=self._n_ingested,
            n_ingest_failed=self._n_ingest_failed,
            dispatch_timeouts=tot["timeouts"],
            guard_violations=len(self.audit.violations),
        )
        if self.slo is not None:
            snap = self.slo.snapshot()
            out["slo_state"] = snap["state"]
            out["slo_state_code"] = snap["state_code"]
            out["slo_window_error_rate"] = snap["error_rate"]
            out["slo_window_p99_ms"] = snap["p99_ms"]
            out["slo"] = snap["objectives"]
            # /metrics carries the numeric twin: alerting keys off
            # fmrp_slo_state{slo=...} >= 1 (warn) / >= 2 (breach)
            reg = telemetry.registry()
            for name, obj in snap["objectives"].items():
                reg.gauge(
                    "fmrp_slo_state",
                    help="SLO state by objective: 0 ok, 1 warn, 2 breach",
                    slo=name, **self._metric_labels,
                ).set(obj["state_code"])
                reg.gauge(
                    "fmrp_slo_burn_rate",
                    help="windowed bad fraction over the SLO budget",
                    slo=name, **self._metric_labels,
                ).set(obj["burn_rate"])
        else:
            out["slo_state"] = None
        return out

    def report(self) -> str:
        """StageTimer-style aligned report of the service counters."""
        lines = [
            f"{name:<40s} {value}"
            for name, value in sorted(self.stats().items())
        ]
        return "\n".join([self.timer.report(), *lines])

    def capture_profile(self, profile_dir):
        """A ``torch.profiler`` capture around a live-serving window, on
        the service's device::

            with svc.capture_profile("/tmp/prof"):
                ...   # the queries in this block are profiled

        Every armed host span in the block also names its interval in the
        profile (``telemetry.profiling``), so the serving batch and
        dispatch spans sit beside the device rows."""
        return telemetry.profiling(profile_dir, device=self.device)

    # -- metrics endpoint hook ---------------------------------------------

    def prometheus_metrics(self) -> str:
        """The process metrics registry plus this service's ``stats()``
        (numeric entries, ``fmrp_serving_service_*`` gauges) in Prometheus
        text exposition format — the payload a scrape endpoint serves."""
        return telemetry.prometheus_text(
            extra=self.stats(), extra_prefix="fmrp_serving_service_"
        )

    def start_metrics_server(self, port: int = 0, host: str = "127.0.0.1"):
        """Serve :meth:`prometheus_metrics` over HTTP (``GET /metrics``) on
        a daemon thread; returns the bound ``(host, port)``. ``port=0``
        picks a free port. The server dies with :meth:`close`."""
        from fm_returnprediction_tpu_torch.telemetry.export import (
            serve_metrics_http,
        )

        if getattr(self, "_metrics_server", None) is not None:
            raise RuntimeError(
                "metrics server already running; close() the service "
                "first (a second bind would orphan the first server's "
                "daemon thread and socket)"
            )
        self._metrics_server = serve_metrics_http(
            self.prometheus_metrics, port=port, host=host,
            name="fmrp-serving-metrics",
        )
        return self._metrics_server.server_address

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self.batcher.close()
        server = getattr(self, "_metrics_server", None)
        if server is not None:
            server.shutdown()
            server.server_close()
            self._metrics_server = None
        # a trace-dir-armed run picks up the serving spans too
        telemetry.flush()

    def __enter__(self) -> "ERService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
