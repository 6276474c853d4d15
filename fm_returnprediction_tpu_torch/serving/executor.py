"""Shape-bucketed projection programs for the online E[r] query.

Request sizes never reach the device directly: batches land in
power-of-two BUCKETS, and each bucket is one program built once, at
warm-up, and reused for every dispatch of that size. Padding rows carry
``valid=False`` and are exact no-ops, so a padded batch returns the same
bits for its real rows whatever bucket it lands in
(``tests/test_torch_serving_batcher.py``).

- **On the card** each bucket is one CUDA graph (``torch.cuda.CUDAGraph``)
  captured at ``warmup()`` over static input and output buffers, on a side
  stream, with ``capture_error_mode="thread_local"`` (the ingest thread
  captures a new executor while the batcher's flusher keeps replaying the
  old one). A dispatch stages its rows through pinned host buffers, copies
  them into the bucket's static buffers, replays the graph and copies the
  output back, all on the executor's serving stream, named explicitly in
  every thread (the dispatch watchdog's worker too: a new thread would get
  the default stream), and synchronizes that stream before returning. A
  graph's static buffers are not reentrant, so each bucket's copy-in,
  replay and copy-out hold the bucket's lock, taken AFTER the fault sites:
  a stalled, abandoned dispatch blocks no later one. This is the port's
  form of the reference's "no compile at query time": after ``warmup()``
  no dispatch captures (``fmrp_serving_executable_compiles_total`` stays
  flat).
- **On the CPU** each bucket is an eager callable of the same projection.

The projection (:func:`er_project`) is the reference's ``_er_kernel`` and
the batch forecast's arithmetic (``models.forecast.rolling_er_forecast``):
gather the month's lagged coefficient means and fitted support, clip the
features to the support, take the masked dot, NaN where the row cannot be
answered. The dot is an explicit loop over the P predictors in order
(elementwise products and sums): every row's value is computed the same
way in every bucket, in a graph or eagerly. Answerability is the
reference's deliberate superset of the batch gate: a row whose realized
return is missing is still quoted (serving quotes at the start of a
month), and so is a month whose own cross-section produced no
coefficient row.

Every bucket build is a cost-ledger record (``telemetry.record_program``):
the capture's wall time and the bucket's analytic FLOPs and bytes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch import telemetry
from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.resilience.errors import DispatchTimeoutError
from fm_returnprediction_tpu_torch.resilience.faults import fault_site

__all__ = ["bucket_sizes", "bucket_for", "er_project", "BucketedExecutor"]

# one capture at a time in the process: a capture between two others' in
# flight would interleave their graph memory pools and side streams
_CAPTURE_LOCK = threading.Lock()


def bucket_sizes(max_batch: int, min_bucket: int = 1) -> Tuple[int, ...]:
    """The power-of-two bucket ladder ``min_bucket .. max_batch`` (both
    rounded UP to powers of two, so the top rung is the smallest power of
    two holding a full ``max_batch`` request batch)."""
    if max_batch < 1 or min_bucket < 1:
        raise ValueError("max_batch and min_bucket must be >= 1")
    lo = 1 << (min_bucket - 1).bit_length()
    hi = 1 << (max_batch - 1).bit_length()
    if lo > hi:
        raise ValueError(f"min_bucket {min_bucket} exceeds max_batch {max_batch}")
    return tuple(1 << k for k in range(lo.bit_length() - 1, hi.bit_length()))


def bucket_for(n: int, max_batch: int, min_bucket: int = 1) -> int:
    """Smallest bucket holding ``n`` rows (monotone in ``n``). The cap is
    ``max_batch`` itself, not the rounded-up ladder top: callers split
    larger batches."""
    if n < 1:
        raise ValueError("batch must hold at least one row")
    ladder = bucket_sizes(max_batch, min_bucket)
    if n > max_batch:
        raise ValueError(f"batch of {n} exceeds max_batch {max_batch}")
    for b in ladder:
        if n <= b:
            return b
    raise AssertionError("unreachable")


def er_project(slopes_bar, intercept_bar, x_lo, x_hi, have_coef, month_idx, x, valid):
    """One bucket's projection: (B,) E[r], NaN for rows it cannot answer.

    A row is answerable when it is real (not padding), every predictor is
    finite, and its month has a lagged coefficient mean. Features clip to
    the month's fitted support (a no-op for in-panel values, a clamp for
    out-of-range raw features); the dot runs over the predictors in order."""
    ok = valid & torch.isfinite(x).all(dim=-1) & have_coef[month_idx]
    xb = torch.minimum(torch.maximum(x, x_lo[month_idx]), x_hi[month_idx])
    xb = torch.where(ok[:, None], xb, 0.0)
    slopes = slopes_bar[month_idx]
    dot = xb[:, 0] * slopes[:, 0]
    for p in range(1, x.shape[1]):
        dot = dot + xb[:, p] * slopes[:, p]
    return torch.where(ok, intercept_bar[month_idx] + dot, float("nan"))


class _EagerBucket:
    """A CPU bucket: the projection called on the padded batch."""

    def __init__(self, state_args):
        self._state_args = state_args

    def __call__(self, month_idx, x, valid) -> np.ndarray:
        return er_project(*self._state_args, torch.from_numpy(month_idx),
                          torch.from_numpy(x), torch.from_numpy(valid)).numpy()


class _GraphBucket:
    """A CUDA bucket: one graph captured over static buffers, replayed on
    the serving stream per dispatch under the bucket's lock."""

    def __init__(self, state_args, size: int, n_pred: int, dtype, device, stream):
        self.lock = threading.Lock()
        self._stream = stream
        self._month_idx = torch.zeros(size, dtype=torch.int64, device=device)
        self._x = torch.zeros(size, n_pred, dtype=dtype, device=device)
        self._valid = torch.zeros(size, dtype=torch.bool, device=device)
        self._h_month_idx = torch.zeros(size, dtype=torch.int64).pin_memory()
        self._h_x = torch.zeros(size, n_pred, dtype=dtype).pin_memory()
        self._h_valid = torch.zeros(size, dtype=torch.bool).pin_memory()
        self._h_out = torch.zeros(size, dtype=dtype).pin_memory()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            # one eager run on the side stream before the capture, so any
            # lazy initialization happens outside it
            er_project(*state_args, self._month_idx, self._x, self._valid)
        side.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.graph(self.graph, stream=side,
                                             capture_error_mode="thread_local"):
            self._out = er_project(*state_args, self._month_idx, self._x, self._valid)
        side.synchronize()

    def release(self) -> None:
        """Free the graph and its buffers once no dispatch holds the
        bucket (a later dispatch raises instead of replaying freed
        memory)."""
        with self.lock:
            if self.graph is not None:
                self.graph.reset()
            self.graph = None
            self._month_idx = self._x = self._valid = self._out = None
            self._h_month_idx = self._h_x = self._h_valid = self._h_out = None

    def __call__(self, month_idx, x, valid) -> np.ndarray:
        with self.lock:
            if self.graph is None:
                raise RuntimeError("serving bucket released (its replica left)")
            self._h_month_idx.numpy()[:] = month_idx
            self._h_x.numpy()[:] = x
            self._h_valid.numpy()[:] = valid
            with torch.cuda.stream(self._stream):
                self._month_idx.copy_(self._h_month_idx, non_blocking=True)
                self._x.copy_(self._h_x, non_blocking=True)
                self._valid.copy_(self._h_valid, non_blocking=True)
                self.graph.replay()
                self._h_out.copy_(self._out, non_blocking=True)
            self._stream.synchronize()
            return self._h_out.numpy().copy()


class BucketedExecutor:
    """Thread-safe cache of one built program per bucket size.

    Counters (read by the service's stats): ``hits``, dispatches served by
    an already-built bucket; ``misses``, dispatches that had to build it
    first (zero after ``warmup()``); ``compiles``, programs built (bucket
    captures on the card); ``timeouts``, dispatches the watchdog failed.
    ``device=None`` means the GPU and raises without one."""

    def __init__(
        self,
        state,
        max_batch: int = 256,
        min_bucket: int = 1,
        dispatch_timeout_s: Optional[float] = None,
        metric_labels: Optional[dict] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        # the watchdog budget per dispatch: a runner stalled inside a device
        # call fails its OWN batch (DispatchTimeoutError on its futures)
        # instead of hanging the microbatcher's flusher; None = direct call
        self.dispatch_timeout_s = dispatch_timeout_s
        bucket_sizes(self.max_batch, self.min_bucket)  # fail fast, not in run()
        self._dtype = state.dtype
        self._torch_dtype = torch.from_numpy(np.zeros(0, self._dtype)).dtype
        self._n_pred = state.n_predictors
        # one device push of the fitted arrays, shared by every bucket
        self._state_args = tuple(
            torch.tensor(np.asarray(a), device=self.device)
            for a in (state.slopes_bar, state.intercept_bar, state.x_lo, state.x_hi,
                      state.have_coef()))
        self._n_months = state.n_months
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the serving stream sees the state pushed on the current one
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._buckets: Dict[int, object] = {}
        self._lock = threading.Lock()
        # per-instance counters in the process-wide registry (the family
        # totals aggregate every executor, retired ones included); the
        # attribute reads below stay plain ints for the service's stats()
        labels = dict(metric_labels or {})
        # fleet identity for the ``fleet.replica_stall`` site (None outside
        # a fleet: a targeted stall mutator then never matches)
        self._replica_tag = labels.get("replica")
        reg = telemetry.registry()
        self._m_hits = reg.private_counter(
            "fmrp_serving_executable_cache_hits_total",
            help="dispatches served by an already-compiled bucket", **labels)
        self._m_misses = reg.private_counter(
            "fmrp_serving_executable_cache_misses_total",
            help="dispatches that had to compile first", **labels)
        self._m_compiles = reg.private_counter(
            "fmrp_serving_executable_compiles_total",
            help="bucket executables built", **labels)
        self._m_timeouts = reg.private_counter(
            "fmrp_serving_dispatch_timeouts_total",
            help="dispatches failed by the watchdog", **labels)

    @property
    def hits(self) -> int:
        return self._m_hits.value

    @property
    def misses(self) -> int:
        return self._m_misses.value

    @property
    def compiles(self) -> int:
        return self._m_compiles.value

    @property
    def timeouts(self) -> int:
        return self._m_timeouts.value

    def buckets(self) -> Tuple[int, ...]:
        return bucket_sizes(self.max_batch, self.min_bucket)

    def _cost(self, bucket: int) -> dict:
        """The bucket's analytic work: the dot's multiply-adds and the
        intercept (2·P FLOPs a row); each input read once (rows, the
        gathered state rows) and the output written once."""
        item = np.dtype(self._dtype).itemsize
        p = self._n_pred
        args = bucket * (8 + p * item + 1)
        gathered = bucket * ((3 * p + 1) * item + 1)
        out = bucket * item
        return dict(flops=float(2 * p * bucket), bytes_accessed=float(args + gathered + out),
                    argument_bytes=args, output_bytes=out)

    def _build(self, bucket: int):
        """Build the bucket's program (a graph capture on the card). Called
        WITHOUT the executor lock held: a build costs far more than a
        dispatch, and dispatches of built buckets must not wait on it."""
        start = time.perf_counter()
        if self.device.type == "cuda":
            built = _GraphBucket(self._state_args, bucket, self._n_pred, self._torch_dtype,
                                 self.device, self._stream)
            provenance = "captured"
        else:
            built = _EagerBucket(self._state_args)
            provenance = "eager"
        telemetry.record_program(
            "serving_bucket", f"B={bucket},P={self._n_pred},{np.dtype(self._dtype).name}",
            time.perf_counter() - start, backend=self.device.type, bucket=bucket,
            provenance=provenance, **self._cost(bucket))
        return built

    def _ensure(self, bucket: int):
        """The bucket's program, built first if needed (published under the
        lock; a rare concurrent duplicate build is harmless)."""
        with self._lock:
            built = self._buckets.get(bucket)
        if built is None:
            with telemetry.span("serving.compile", cat="compile", bucket=bucket):
                fresh = self._build(bucket)
            with self._lock:
                built = self._buckets.setdefault(bucket, fresh)
            self._m_compiles.inc()
        return built

    def warmup(self) -> Tuple[int, ...]:
        """Build every bucket up front so no query ever pays a build."""
        for b in self.buckets():
            self._ensure(b)
        return self.buckets()

    def release(self) -> None:
        """Drop every bucket program and the state on the device, after
        the dispatches in flight on them end, then synchronize the serving
        stream: once this returns the executor does no more device work
        and holds no device memory (the fleet calls it when a replica
        leaves). Idempotent."""
        with self._lock:
            buckets, self._buckets = self._buckets, {}
        for built in buckets.values():
            if isinstance(built, _GraphBucket):
                built.release()
        self._state_args = ()
        if self._stream is not None:
            self._stream.synchronize()

    def _padded(self, month_idx, x, valid):
        month_idx = np.asarray(month_idx, dtype=np.int64)
        x = np.asarray(x, dtype=self._dtype)
        b = month_idx.shape[0]
        if valid is None:
            valid = np.ones(b, dtype=bool)
        valid = np.asarray(valid, dtype=bool)
        bucket = bucket_for(b, self.max_batch, self.min_bucket)
        pad = bucket - b
        if pad:
            # month 0 on padding rows is a safe gather; valid=False makes
            # the row an exact no-op
            month_idx = np.concatenate([month_idx, np.zeros(pad, np.int64)])
            x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        return b, bucket, month_idx, x, valid

    def run(self, month_idx, x, valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Execute one request batch: pad to its bucket, dispatch, trim.

        month_idx : (B,) int month slots; x : (B, P); valid : (B,) bool
        (rows the caller already knows are unanswerable). Returns (B,)
        E[r] as numpy, NaN where unavailable."""
        b, bucket, month_idx, x, valid = self._padded(month_idx, x, valid)
        with self._lock:
            built = bucket in self._buckets
        (self._m_hits if built else self._m_misses).inc()
        program = self._ensure(bucket)
        with telemetry.span("serving.dispatch", cat="serving", bucket=bucket, rows=b):
            out = self._dispatch(program, bucket, month_idx, x, valid)
        return out[:b]

    def run_eager(self, month_idx, x, valid: Optional[np.ndarray] = None) -> np.ndarray:
        """The same padded batch through the projection called eagerly on
        the executor's device (no bucket program, no counter): the
        reference a graph replay is held to."""
        b, _, month_idx, x, valid = self._padded(month_idx, x, valid)
        if self._stream is None:
            args = [torch.from_numpy(a) for a in (month_idx, x, valid)]
            return er_project(*self._state_args, *args).numpy()[:b]
        with torch.cuda.stream(self._stream):
            args = [torch.tensor(a, device=self.device) for a in (month_idx, x, valid)]
            out = er_project(*self._state_args, *args).cpu().numpy()
        return out[:b]

    def _dispatch(self, program, bucket: int, month_idx, x, valid):
        """One dispatch, optionally watchdogged.

        The fault sites sit INSIDE the dispatched call, before the bucket's
        lock, so an injected stall is exactly what a wedged runner looks
        like to the watchdog and holds no lock a later dispatch needs."""

        def call():
            fault_site("fleet.replica_stall", payload=self._replica_tag)
            fault_site("serving.dispatch")
            return program(month_idx, x, valid)

        if self.dispatch_timeout_s is None:
            return call()
        result: Dict[str, object] = {}
        parent = telemetry.capture()  # threads do not inherit the context

        def target() -> None:
            try:
                with telemetry.attach(parent):
                    result["out"] = call()
            except BaseException as exc:  # noqa: BLE001 — relayed below
                result["err"] = exc

        worker = threading.Thread(target=target, daemon=True, name="fmrp-serving-dispatch")
        worker.start()
        worker.join(self.dispatch_timeout_s)
        if worker.is_alive():
            self._m_timeouts.inc()
            telemetry.event("serving.dispatch_timeout", cat="serving", bucket=bucket,
                            timeout_s=self.dispatch_timeout_s)
            telemetry.dump_flight(f"serving.dispatch_timeout:bucket={bucket}")
            raise DispatchTimeoutError(
                f"bucket {bucket} dispatch exceeded {self.dispatch_timeout_s}s "
                "(runner stalled; worker abandoned)")
        if "err" in result:
            raise result["err"]  # type: ignore[misc]
        return result["out"]
