"""Thread-safe microbatcher: coalesce tiny E[r] queries into bucket batches.

Single-firm queries are the worst shape an accelerator can see — one
dispatch per row pays the full host→device round trip for a dot product.
The batcher sits between callers and the bucketed executor and coalesces
concurrent requests under three knobs:

- ``max_batch``     — flush as soon as this many requests are pending
  (the largest bucket the executor compiled);
- ``max_latency_ms``— flush no later than this after the OLDEST pending
  request arrived (tail-latency bound: a lone query never waits for a
  batch that isn't coming);
- ``max_queue``     — BACKPRESSURE: ``submit`` raises :class:`QueueFullError`
  when this many requests are already pending, instead of blocking the
  caller forever behind a stalled executor. Callers shed load or retry;
  the error is the documented contract, not an accident.

``submit`` returns a ``concurrent.futures.Future``; a background flusher
thread (``auto_flush=True``, the service default) drains the queue, or the
owner calls ``flush()``/``drain()`` manually (deterministic tests). The
batcher also owns the queue-side metrics — per-request latency quantiles
and batch occupancy (rows per bucket slot) — which the service merges with
the executor's cache counters.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, NamedTuple, Optional

import numpy as np

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.serving.executor import bucket_for

__all__ = ["QueueFullError", "MicroBatcher"]

_METRICS_WINDOW = 8192  # ring-buffer length for latency/occupancy quantiles


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when ``max_queue`` requests are already pending.

    The backpressure contract: the service NEVER blocks a producer on a
    stalled consumer — it fails fast and lets the caller shed or retry.
    Carries the evidence of the decision so shed logic upstream never has
    to re-derive it: ``queue_depth``, pending requests at rejection time;
    ``max_queue``, the configured ceiling; ``occupancy``, their ratio.
    """

    def __init__(self, message: str, *, queue_depth=None, max_queue=None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.max_queue = max_queue

    @property
    def occupancy(self):
        """Queue fill fraction at rejection time (None when unknown)."""
        if not self.max_queue or self.queue_depth is None:
            return None
        return self.queue_depth / self.max_queue


class _Pending(NamedTuple):
    month_idx: int
    x: np.ndarray
    future: Future
    t_submit: float


class MicroBatcher:
    """Coalesce single-row requests into padded bucket batches.

    ``runner(month_idx (B,), x (B, P), valid (B,)) -> (B,) np.ndarray`` is
    the executor hop (``BucketedExecutor.run``); the batcher itself never
    touches a tensor.
    """

    def __init__(
        self,
        runner: Callable[..., np.ndarray],
        max_batch: int = 256,
        max_latency_ms: float = 2.0,
        max_queue: int = 1024,
        auto_flush: bool = True,
        n_predictors: Optional[int] = None,
        min_bucket: int = 1,
        observer: Optional[Callable] = None,
        metric_labels: Optional[dict] = None,
    ):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._runner = runner
        # per-request outcome hook ``observer(latency_s, ok, queue_depth)``
        # — the service's SLO monitor feeds from it (latency_s is None for
        # a backpressure reject, queue_depth None when unknown). Called
        # outside the batcher lock and never allowed to raise into the
        # flusher.
        self._observer = observer
        # when known, row shape is enforced at SUBMIT so one malformed
        # request fails alone instead of poisoning its whole batch
        self._n_predictors = n_predictors
        self.max_batch = int(max_batch)
        # must mirror the executor's ladder floor: occupancy is rows per
        # DISPATCHED slot, and the executor never dispatches a bucket
        # smaller than min_bucket
        self.min_bucket = int(min_bucket)
        self.max_latency_s = float(max_latency_ms) / 1e3
        self.max_queue = int(max_queue)
        self._pending: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        # quantile RINGS stay instance-local (exact p50/p99 for stats(): a
        # fixed-bucket histogram cannot reproduce an exact percentile); the
        # HISTOGRAMS feed the registry's Prometheus export
        self._latencies: deque = deque(maxlen=_METRICS_WINDOW)
        self._occupancy: deque = deque(maxlen=_METRICS_WINDOW)
        # counters live in the process-wide metrics registry (per-instance
        # instruments aggregated per family); stats() reads .value as the
        # same plain ints it always returned. ``metric_labels`` (e.g. the
        # fleet's ``replica="r0"``) splits every family per labelset.
        labels = dict(metric_labels or {})
        reg = telemetry.registry()
        self._m_done = reg.private_counter(
            "fmrp_serving_requests_done_total",
            help="requests answered (result or NaN) by the microbatcher",
            **labels,
        )
        self._m_rejected = reg.private_counter(
            "fmrp_serving_requests_rejected_total",
            help="submissions refused under backpressure (QueueFullError)",
            **labels,
        )
        self._m_batches = reg.private_counter(
            "fmrp_serving_batches_total", help="batches dispatched",
            **labels,
        )
        self._m_failed = reg.private_counter(
            "fmrp_serving_requests_failed_total",
            help="requests whose batch runner raised",
            **labels,
        )
        self._m_failed_batches = reg.private_counter(
            "fmrp_serving_failed_batches_total",
            help="batches whose runner raised",
            **labels,
        )
        self._m_latency = reg.private_histogram(
            "fmrp_serving_request_latency_seconds",
            help="submit-to-result latency per request",
            **labels,
        )
        self._m_occupancy = reg.private_histogram(
            "fmrp_serving_batch_occupancy",
            help="rows per dispatched bucket slot",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
            **labels,
        )
        self._thread: Optional[threading.Thread] = None
        if auto_flush:
            self._thread = threading.Thread(
                target=self._flush_loop, name="fmrp-serving-batcher", daemon=True
            )
            self._thread.start()

    # -- producer side ----------------------------------------------------

    def submit(self, month_idx: int, x: np.ndarray) -> Future:
        """Enqueue one query; returns its Future. Raises ``ValueError`` for
        a malformed feature row (that request alone — batch-mates are not
        poisoned), :class:`QueueFullError` immediately when the queue is
        full, and ``RuntimeError`` after ``close()``."""
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError(f"feature row must be 1-D (P,), got {x.shape}")
        fut: Future = Future()
        req = _Pending(int(month_idx), x, fut, time.perf_counter())
        rejected_depth = None
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            # a malformed row must fail ALONE — never poison its batch-mates
            # in np.stack, never kill the flusher thread, and never wedge
            # the batcher itself. With a declared width it fails right here;
            # without one, _take_batch keeps each batch width-homogeneous,
            # so a wrong-width row meets the executor's shape check in a
            # batch of its own kind and the error lands on its future(s)
            if (
                self._n_predictors is not None
                and x.shape[0] != self._n_predictors
            ):
                raise ValueError(
                    f"feature row must have shape ({self._n_predictors},), "
                    f"got {x.shape}"
                )
            if len(self._pending) >= self.max_queue:
                self._m_rejected.inc()
                rejected_depth = len(self._pending)
            else:
                self._pending.append(req)
                depth = len(self._pending)
                self._cv.notify_all()
        if rejected_depth is not None:
            # event + observer OUTSIDE the lock (the observer contract):
            # a blocking SLO hook during a queue-full storm must not
            # serialize every submit and the flusher behind it
            telemetry.event(
                "serving.reject", cat="serving", queue_depth=rejected_depth,
            )
            self._notify(None, False, rejected_depth)
            raise QueueFullError(
                f"serving queue full ({rejected_depth} pending of "
                f"{self.max_queue} ceiling); shed load or retry",
                queue_depth=rejected_depth, max_queue=self.max_queue,
            )
        telemetry.event(
            "serving.submit", cat="serving",
            month_idx=req.month_idx, queue_depth=depth,
        )
        return fut

    def submit_many(self, reqs) -> list:
        """Bulk enqueue: ``reqs`` = [(month_idx, x), ...] → one result
        per request, either ``("ok", Future)`` or ``("err", exception)``:
        the EXACT per-row semantics of :meth:`submit` (a malformed row, a
        full queue or a closed batcher fail alone), paid under ONE lock
        acquisition and one flusher notify."""
        now = time.perf_counter()
        out: list = []
        rejected = 0
        with self._cv:
            depth = len(self._pending)
            for month_idx, x in reqs:
                if self._closed:
                    out.append(("err", RuntimeError("batcher is closed")))
                    continue
                try:
                    x = np.asarray(x)
                except Exception as exc:  # noqa: BLE001 — a ragged or
                    # unconvertible row fails ALONE (the submit() contract)
                    out.append(("err", ValueError(
                        f"feature row is not array-like: {exc!r}"[:300])))
                    continue
                if x.ndim != 1:
                    out.append(("err", ValueError(
                        f"feature row must be 1-D (P,), got {x.shape}")))
                    continue
                if (
                    self._n_predictors is not None
                    and x.shape[0] != self._n_predictors
                ):
                    out.append(("err", ValueError(
                        f"feature row must have shape "
                        f"({self._n_predictors},), got {x.shape}")))
                    continue
                if depth >= self.max_queue:
                    self._m_rejected.inc()
                    rejected += 1
                    out.append(("err", QueueFullError(
                        f"serving queue full ({depth} pending of "
                        f"{self.max_queue} ceiling); shed load or retry",
                        queue_depth=depth, max_queue=self.max_queue,
                    )))
                    continue
                fut: Future = Future()
                self._pending.append(
                    _Pending(int(month_idx), x, fut, now)
                )
                depth += 1
                out.append(("ok", fut))
            if depth:
                self._cv.notify_all()
        n_ok = sum(1 for kind, _ in out if kind == "ok")
        telemetry.event(
            "serving.submit_many", cat="serving", rows=n_ok,
            rejected=rejected, queue_depth=depth,
        )
        for _ in range(rejected):  # SLO burn counts each reject
            self._notify(None, False, depth)
        return out

    # -- consumer side -----------------------------------------------------

    def flush(self) -> int:
        """Synchronously run ONE batch (up to ``max_batch`` requests) from
        the queue; returns how many requests it served (0 = queue empty)."""
        with self._cv:
            batch = self._take_batch()
        if batch:
            self._run_batch(batch)
        return len(batch)

    def drain(self) -> int:
        """Flush until the queue is empty; returns total requests served."""
        total = 0
        while True:
            served = self.flush()
            if not served:
                return total
            total += served

    def _take_batch(self):
        # one batch = one np.stack = ONE row width; with no declared width,
        # rows that don't match the batch head stay queued for the next
        # flush so a malformed row can only sink with its own kind
        batch = []
        skipped = []
        width = None
        while self._pending and len(batch) < self.max_batch:
            req = self._pending.popleft()
            if width is None:
                width = req.x.shape[0]
            if req.x.shape[0] != width:
                skipped.append(req)
                continue
            batch.append(req)
        for req in reversed(skipped):
            self._pending.appendleft(req)
        return batch

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not self._pending:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                # flush when the batch is full or the oldest request's
                # latency budget is spent — whichever comes first
                deadline = self._pending[0].t_submit + self.max_latency_s
                while (
                    not self._closed
                    and len(self._pending) < self.max_batch
                    and (wait := deadline - time.perf_counter()) > 0
                ):
                    self._cv.wait(wait)
                batch = self._take_batch()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch) -> None:
        # batch assembly INSIDE the try: no exception may escape into the
        # flusher thread (a dead flusher strands every future after it) —
        # everything lands on the batch's futures instead
        try:
            with telemetry.span("serving.batch", cat="serving",
                                rows=len(batch)):
                month_idx = np.asarray(
                    [r.month_idx for r in batch], dtype=np.int32
                )
                x = np.stack([r.x for r in batch])
                valid = np.ones(len(batch), dtype=bool)
                out = self._runner(month_idx, x, valid)
        except Exception as exc:  # noqa: BLE001 - delivered per-request
            self._m_failed_batches.inc()
            self._m_failed.inc(len(batch))
            now = time.perf_counter()
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(exc)
                self._notify(now - r.t_submit, False, None)
            return
        now = time.perf_counter()
        occupancy = len(batch) / bucket_for(
            len(batch), self.max_batch, self.min_bucket
        )
        self._m_occupancy.observe(occupancy)
        self._m_batches.inc()
        self._m_done.inc(len(batch))
        with self._cv:
            self._occupancy.append(occupancy)
            depth = len(self._pending)
            lats = []
            for r in batch:
                lat = now - r.t_submit
                lats.append(lat)
                self._latencies.append(lat)
                self._m_latency.observe(lat)
        for r, value in zip(batch, out):
            if not r.future.cancelled():
                r.future.set_result(float(value))
        for lat in lats:
            self._notify(lat, True, depth)

    def _notify(self, latency_s, ok: bool, queue_depth) -> None:
        if self._observer is None:
            return
        try:
            self._observer(latency_s, ok, queue_depth)
        except Exception:  # noqa: BLE001 — an SLO hook must never be able
            pass  # to kill the flusher thread or fail a submit

    # -- lifecycle / metrics ----------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Pending requests right now: a lock-free read (``len`` of a deque
        is atomic), cheap enough for the fleet's admission check on every
        submit."""
        return len(self._pending)

    def abort(self, exc: BaseException) -> int:
        """Abrupt death: stop accepting work and FAIL every queued request
        with ``exc``, no drain, no flush (``ERService.kill``): nothing is
        silently stranded. A batch already mid-dispatch in the flusher
        still resolves on its own (each future resolves exactly once
        either way). Returns how many queued requests were failed."""
        with self._cv:
            self._closed = True
            stranded = list(self._pending)
            self._pending.clear()
            self._cv.notify_all()
        self._m_failed.inc(len(stranded))
        for r in stranded:
            if not r.future.cancelled():
                r.future.set_exception(exc)
            self._notify(None, False, None)
        return len(stranded)

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, then drain what is already queued — via the
        flusher thread when there is one, synchronously otherwise (no
        future may be left dangling for a caller to time out on). If the
        flusher cannot finish within ``timeout`` (a runner stalled
        mid-batch), the still-queued requests FAIL with ``RuntimeError``
        rather than being silently stranded — same fail-fast stance as the
        backpressure contract."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                with self._cv:
                    stranded = list(self._pending)
                    self._pending.clear()
                exc = RuntimeError(
                    "batcher close timed out with the runner stalled; "
                    f"{len(stranded)} queued request(s) abandoned"
                )
                for r in stranded:
                    if not r.future.cancelled():
                        r.future.set_exception(exc)
        else:
            self.drain()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        with self._cv:
            lat = np.asarray(self._latencies, dtype=np.float64)
            occ = np.asarray(self._occupancy, dtype=np.float64)
            out = {
                "queue_depth": len(self._pending),
                "n_done": self._m_done.value,
                "n_rejected": self._m_rejected.value,
                "n_batches": self._m_batches.value,
                "n_failed": self._m_failed.value,
                "n_failed_batches": self._m_failed_batches.value,
            }
        out["p50_ms"] = float(np.percentile(lat, 50) * 1e3) if len(lat) else None
        out["p99_ms"] = float(np.percentile(lat, 99) * 1e3) if len(lat) else None
        out["batch_occupancy"] = float(occ.mean()) if len(occ) else None
        return out
