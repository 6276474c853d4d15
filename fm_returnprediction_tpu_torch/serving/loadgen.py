"""Adversarial multi-worker load harness + capacity model for the fleet.

The fleet's "survives overload" claim needs an adversary: this module
drives a :class:`~fm_returnprediction_tpu_torch.serving.fleet.ServingFleet`
with the traffic shapes that actually break serving systems —

- **bursts**        — closed-loop worker threads slamming the front door
  as fast as admission lets them;
- **sustained ramps** — open-loop arrival schedules whose instantaneous
  rate GROWS through the phase (the overload episode's on-ramp);
- **hot-key skew**  — a fraction of requests pinned to one affinity key,
  so consistent-hash routing concentrates them on one replica;
- **poison payloads** — malformed feature rows (wrong width) mixed into
  the stream: they must fail alone, never take a batch or a replica down.

Every request goes through :func:`query_with_retry` (when the phase asks
for it) — the shared retrying submit helper that CONSUMES the 429's
``retry_after_s`` hint as a backoff floor, reusing
``resilience.call_with_retry``. It is exported for real clients too: the
hint the admission controller computes finally has a consumer.

Outcomes are typed, per request: ``ok`` / ``degraded`` (a
:class:`~fm_returnprediction_tpu_torch.serving.brownout.DegradedQuote` — the
brownout ladder answered, disclosure preserved) / ``shed`` (overloaded
after the retry budget) / ``poison_rejected`` / ``error``. The per-phase
report carries rows/s, p50/p99, shed rate and degraded fraction — the
series a capacity curve is drawn from.

:func:`capacity_model` predicts rows/s per replica from the cost ledger
(the serving-bucket programs' analytic FLOPs and bytes against the card's
peaks) and a measured single-dispatch probe, to hold against the
harness's measured throughput.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from fm_returnprediction_tpu_torch.resilience.errors import (
    RetryExhaustedError,
    ServiceOverloadError,
)
from fm_returnprediction_tpu_torch.resilience.retry import (
    RetryPolicy,
    call_with_retry,
)
from fm_returnprediction_tpu_torch.serving.brownout import DegradedQuote

__all__ = [
    "query_with_retry",
    "LoadPhase",
    "LoadGen",
    "capacity_model",
    "portfolio_consumer",
]

#: the shared client-side policy: small budget, fast first backoff —
#: the retry_after_s hint (not this curve) is what actually paces a
#: well-behaved client under shed
DEFAULT_RETRY = RetryPolicy(
    max_attempts=4, backoff_s=0.005, multiplier=2.0,
    retry_on=(ServiceOverloadError,),
)


def query_with_retry(fleet, month, x, *, policy: Optional[RetryPolicy] = None,
                     sleep: Callable[[float], None] = time.sleep,
                     timeout: Optional[float] = 30.0):
    """Blocking fleet query that treats ``ServiceOverloadError`` as the
    retriable contract it is: each 429's ``retry_after_s`` hint becomes
    the FLOOR under the policy's backoff delay (the hint is the admission
    controller's own capacity estimate — sleeping less just re-sheds).
    Reuses ``resilience.call_with_retry`` for the budget/backoff/telemetry
    discipline; raises ``RetryExhaustedError`` when the budget is spent
    with the last 429 as ``__cause__``."""
    policy = policy or DEFAULT_RETRY
    last: dict = {}

    def on_retry(attempt, err):
        last["err"] = err

    def floored_sleep(delay: float) -> None:
        hint = float(getattr(last.get("err"), "retry_after_s", 0.0) or 0.0)
        sleep(max(delay, hint))

    return call_with_retry(
        lambda: fleet.query(month, x, timeout=timeout),
        policy, label="fleet.query", sleep=floored_sleep, on_retry=on_retry,
    )


@dataclasses.dataclass(frozen=True)
class LoadPhase:
    """One traffic shape.

    n_requests  : requests this phase issues (split across ``workers``).
    workers     : concurrent submitting threads.
    rate_per_s  : open-loop aggregate arrival rate; None = closed loop
        (every worker submits as fast as its answers come back — a burst).
    ramp        : with a rate, grow the instantaneous rate linearly from
        ~0 to ~2×``rate_per_s`` across the phase (same mean arrival count,
        sustained-ramp shape).
    hot_key_frac: fraction of requests routed with the SAME affinity key
        ("hot"), concentrating them on one replica via the hash ring.
    poison_frac : fraction of requests carrying a malformed feature row
        (wrong predictor width) — they must fail alone.
    retry       : consume 429 hints via :func:`query_with_retry`; off, a
        shed is terminal for its request.
    """

    name: str
    n_requests: int
    workers: int = 4
    rate_per_s: Optional[float] = None
    ramp: bool = False
    hot_key_frac: float = 0.0
    poison_frac: float = 0.0
    retry: bool = True


class LoadGen:
    """Deterministic adversarial load against one fleet.

    ``months``/``rows`` are the quotable sample space: request ``k`` of a
    phase draws (month, feature row, poison?, hot?) from a seeded rng, so
    two runs of the same phases issue identical streams. ``tick_s`` arms
    a ticker thread calling ``fleet.supervisor.tick()`` at that cadence
    while phases run, so the autoscaler and brownout machinery act
    mid-load."""

    def __init__(self, fleet, months: Sequence[int], rows: np.ndarray,
                 seed: int = 0, tick_s: Optional[float] = None):
        self.fleet = fleet
        self.months = np.asarray(months, dtype=np.int64)
        self.rows = np.asarray(rows)
        if len(self.months) != len(self.rows):
            raise ValueError("months and rows must align")
        self.seed = int(seed)
        self.tick_s = tick_s
        self.phase_reports: List[dict] = []

    def _schedule(self, phase: LoadPhase, t0: float) -> Optional[np.ndarray]:
        """Absolute target start times (None = closed loop). Ramp uses a
        sqrt profile: arrival k at ``T·√(k/n)`` has instantaneous rate
        growing linearly from ~0 to 2×mean — same total, rising pressure."""
        if phase.rate_per_s is None:
            return None
        total_s = phase.n_requests / phase.rate_per_s
        k = np.arange(phase.n_requests, dtype=np.float64)
        if phase.ramp:
            offsets = total_s * np.sqrt(k / max(phase.n_requests - 1, 1))
        else:
            offsets = k / phase.rate_per_s
        return t0 + offsets

    def run(self, phases: Sequence[LoadPhase]) -> dict:
        """Drive every phase in order; returns the full report (one dict
        per phase + totals), also kept on ``self.phase_reports``."""
        ticker_stop = threading.Event()
        ticker = None
        if self.tick_s:
            def _tick_loop():
                while not ticker_stop.wait(self.tick_s):
                    try:
                        self.fleet.supervisor.tick()
                    except Exception:  # noqa: BLE001 — ticks must survive
                        pass

            ticker = threading.Thread(
                target=_tick_loop, name="fmrp-loadgen-ticker", daemon=True
            )
            ticker.start()
        this_run: List[dict] = []
        try:
            for phase in phases:
                report = self._run_phase(phase)
                this_run.append(report)
                self.phase_reports.append(report)
        finally:
            ticker_stop.set()
            if ticker is not None:
                ticker.join(timeout=2.0)
        # totals cover THIS call only — phase_reports keeps the all-time
        # history, but a second run() must not re-report the first run's
        # traffic as its own
        totals = {
            k: int(sum(r[k] for r in this_run))
            for k in ("n", "ok", "degraded", "shed", "poison_rejected",
                      "errors", "retries")
        }
        return {"phases": this_run, **totals}

    def _run_phase(self, phase: LoadPhase) -> dict:
        # sha256, not hash(): the per-process salt on str hashing would
        # make "the same phases issue identical streams" false across runs
        salt = int.from_bytes(
            hashlib.sha256(phase.name.encode()).digest()[:4], "big"
        )
        rng = np.random.default_rng((self.seed, salt))
        n = phase.n_requests
        pick = rng.integers(0, len(self.months), n)
        poison = rng.random(n) < phase.poison_frac
        hot = rng.random(n) < phase.hot_key_frac
        lat = np.full(n, np.nan)
        outcome = np.zeros(n, dtype=np.int8)  # 1 ok 2 degraded 3 shed
        #                                       4 poison_rejected 5 error
        p = self.rows.shape[1]
        t0 = time.perf_counter()
        schedule = self._schedule(phase, t0)

        def one(k: int) -> None:
            if schedule is not None:
                delay = schedule[k] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            month = int(self.months[pick[k]])
            x = self.rows[pick[k]]
            if poison[k]:
                x = np.zeros(p + 3, dtype=self.rows.dtype)  # wrong width
            key = "hot" if hot[k] else None
            tq = time.perf_counter()
            try:
                if phase.retry:
                    out = query_with_retry(
                        self.fleet, month, x
                    ) if key is None else query_with_retry(
                        _Keyed(self.fleet, key), month, x
                    )
                else:
                    out = self.fleet.submit(month, x, key=key).result(
                        timeout=30.0
                    )
            except (ServiceOverloadError, RetryExhaustedError):
                outcome[k] = 3
                return
            except Exception:  # noqa: BLE001 — typed below
                outcome[k] = 4 if poison[k] else 5
                return
            lat[k] = time.perf_counter() - tq
            if poison[k]:
                # a malformed row that came back NaN failed politely;
                # anything finite would be a correctness bug upstream
                outcome[k] = 4 if not np.isfinite(out) else 5
            else:
                outcome[k] = 2 if isinstance(out, DegradedQuote) else 1

        # one phase-level window over the shared retry counter: concurrent
        # per-request windows would each span the other workers' retries
        # and multiply the count (any OTHER layer retrying during the
        # phase still lands here — a process-wide counter can only be
        # attributed process-wide, and the phase discloses an aggregate)
        retries_before = _retry_count()
        idx = list(range(n))
        chunks = [idx[w::phase.workers] for w in range(phase.workers)]

        def worker(chunk: List[int]) -> None:
            for k in chunk:
                one(k)

        threads = [
            threading.Thread(target=worker, args=(c,), daemon=True)
            for c in chunks if c
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        retries = _retry_count() - retries_before
        answered = int((outcome == 1).sum() + (outcome == 2).sum())
        lats = lat[np.isfinite(lat)]
        return {
            "phase": phase.name,
            "n": n,
            "ok": int((outcome == 1).sum()),
            "degraded": int((outcome == 2).sum()),
            "shed": int((outcome == 3).sum()),
            "poison_rejected": int((outcome == 4).sum()),
            "errors": int((outcome == 5).sum()),
            "retries": int(max(retries, 0)),
            "wall_s": round(wall, 4),
            "rows_per_s": round(answered / wall, 1) if wall > 0 else None,
            "p50_ms": (round(float(np.percentile(lats, 50) * 1e3), 3)
                       if len(lats) else None),
            "p99_ms": (round(float(np.percentile(lats, 99) * 1e3), 3)
                       if len(lats) else None),
            # per-route split: under brownout the degraded p99 is the
            # "SLO held" evidence (host-side answers bypass the queues)
            "p99_ms_full": _p99(lat[outcome == 1]),
            "p99_ms_degraded": _p99(lat[outcome == 2]),
            "degraded_frac": round(answered and
                                   float((outcome == 2).sum()) / answered, 4),
            "shed_rate": round(float((outcome == 3).sum()) / n, 4),
        }


def _p99(lats: np.ndarray) -> Optional[float]:
    lats = lats[np.isfinite(lats)]
    if not len(lats):
        return None
    return round(float(np.percentile(lats, 99) * 1e3), 3)


class _Keyed:
    """Minimal fleet view pinning the affinity key (hot-key phases)."""

    __slots__ = ("_fleet", "_key")

    def __init__(self, fleet, key: str):
        self._fleet = fleet
        self._key = key

    def query(self, month, x, timeout=30.0):
        return self._fleet.submit(month, x, key=self._key).result(
            timeout=timeout
        )


def _retry_count() -> int:
    from fm_returnprediction_tpu_torch import telemetry

    return int(telemetry.registry().counter(
        "fmrp_retry_attempts_total",
        help="retryable attempt failures across every layer",
    ).value)


def portfolio_consumer(
    fleet,
    months: Sequence[int],
    rows: np.ndarray,
    valid: Optional[np.ndarray] = None,
    n_quantiles: int = 5,
    workers: int = 4,
    retry: bool = True,
    timeout: float = 30.0,
) -> dict:
    """The backtest's portfolio-construction phase run as a FLEET CLIENT:
    every E[r] that feeds a sort is a quote served THROUGH the front door
    (admission, routing, microbatching, brownout), not a batch matmul the
    consumer ran itself.

    ``months`` (M,) are the formation months; ``rows`` (M, N, P) the
    per-month feature cross-sections; ``valid`` (M, N) the quotable mask
    (default: rows with all-finite features). Worker threads stream the
    M·N quotes (:func:`query_with_retry` when ``retry``), then portfolios
    form HOST-SIDE with the exact ``backtest.portfolio`` conventions —
    ``np.quantile`` linear breakpoints at the interior quantiles, bucket =
    count of breakpoints STRICTLY below the quote (ties deterministic),
    long = top bucket / short = bottom, equal weights, one-way turnover
    ``0.5·Σ|Δw|`` per leg across consecutive formed months.

    The report extends the :class:`LoadGen` phase schema (rows/s,
    p50/p99, shed/degraded counts) with the formed-portfolio series and
    carries the raw ``quotes`` (M, N) array so a differential test can
    pin the fleet-served panel bit-identical to the batch executor's."""
    months = np.asarray(months, dtype=np.int64)
    rows = np.asarray(rows)
    if rows.ndim != 3 or len(months) != rows.shape[0]:
        raise ValueError("rows must be (M, N, P) aligned with months")
    m_months, n_firms, _ = rows.shape
    if valid is None:
        valid = np.isfinite(rows).all(axis=-1)
    valid = np.asarray(valid, bool)
    if n_quantiles < 2:
        raise ValueError("n_quantiles must be >= 2")

    quotes = np.full((m_months, n_firms), np.nan)
    outcome = np.zeros((m_months, n_firms), dtype=np.int8)
    lat = np.full(m_months * n_firms, np.nan)

    todo = [(mi, fi) for mi in range(m_months) for fi in range(n_firms)
            if valid[mi, fi]]
    t0 = time.perf_counter()

    def one(k: int, mi: int, fi: int) -> None:
        tq = time.perf_counter()
        try:
            if retry:
                out = query_with_retry(fleet, int(months[mi]), rows[mi, fi],
                                       timeout=timeout)
            else:
                out = fleet.query(int(months[mi]), rows[mi, fi],
                                  timeout=timeout)
        except (ServiceOverloadError, RetryExhaustedError):
            outcome[mi, fi] = 3
            return
        except Exception:  # noqa: BLE001 — counted, not fatal
            outcome[mi, fi] = 5
            return
        lat[k] = time.perf_counter() - tq
        quotes[mi, fi] = float(out)
        outcome[mi, fi] = 2 if isinstance(out, DegradedQuote) else 1

    chunks = [todo[w::workers] for w in range(workers)]

    def worker(w: int, chunk) -> None:
        base = w
        for j, (mi, fi) in enumerate(chunk):
            one(base + j * workers, mi, fi)

    threads = [
        threading.Thread(target=worker, args=(w, c), daemon=True)
        for w, c in enumerate(chunks) if c
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0

    # host-side formation on whatever quotes came back finite — the same
    # tie-deterministic bucket convention as backtest.portfolio
    q_interior = np.arange(1, n_quantiles) / n_quantiles
    formed = []
    long_w = np.zeros((m_months, n_firms))
    short_w = np.zeros((m_months, n_firms))
    for mi in range(m_months):
        good = np.isfinite(quotes[mi])
        if good.sum() < n_quantiles:
            continue
        vals = quotes[mi, good]
        bp = np.quantile(vals, q_interior)  # linear interpolation
        bucket = (bp[None, :] < quotes[mi, good, None]).sum(axis=1)
        gi = np.flatnonzero(good)
        top = gi[bucket == n_quantiles - 1]
        bot = gi[bucket == 0]
        if not len(top) or not len(bot):
            continue
        long_w[mi, top] = 1.0 / len(top)
        short_w[mi, bot] = 1.0 / len(bot)
        formed.append(mi)
    turnovers = [
        0.5 * (np.abs(long_w[b] - long_w[a]).sum()
               + np.abs(short_w[b] - short_w[a]).sum()) / 2.0
        for a, b in zip(formed, formed[1:])
    ]

    n = len(todo)
    answered = int((outcome == 1).sum() + (outcome == 2).sum())
    lats = lat[np.isfinite(lat)]
    return {
        "phase": "portfolio_consumer",
        "n": n,
        "ok": int((outcome == 1).sum()),
        "degraded": int((outcome == 2).sum()),
        "shed": int((outcome == 3).sum()),
        "errors": int((outcome == 5).sum()),
        "wall_s": round(wall, 4),
        "rows_per_s": round(answered / wall, 1) if wall > 0 else None,
        "p50_ms": (round(float(np.percentile(lats, 50) * 1e3), 3)
                   if len(lats) else None),
        "p99_ms": _p99(lat),
        "months_requested": int(m_months),
        "months_formed": len(formed),
        "long_size_mean": (round(float(np.mean(
            [(long_w[mi] > 0).sum() for mi in formed])), 2)
            if formed else None),
        "short_size_mean": (round(float(np.mean(
            [(short_w[mi] > 0).sum() for mi in formed])), 2)
            if formed else None),
        "turnover_mean": (round(float(np.mean(turnovers)), 4)
                          if turnovers else None),
        "quotes": quotes,
        "long_weights": long_w,
        "short_weights": short_w,
    }


def capacity_model(fleet, probe_repeats: int = 5) -> dict:
    """Predicted fleet throughput from first principles, to hold the
    measured capacity against.

    Three ceilings per replica, the lowest of which binds:

    - **dispatch ceiling**: ``max_batch`` rows retire per dispatch, and a
      dispatch takes ``max(dispatch_wall, max_latency)`` (the flush window
      is a floor: a batch waits for it before dispatching). The dispatch
      wall is MEASURED here with a full-bucket probe on one replica.
    - **FLOP roofline**: the top bucket's analytic FLOPs per row (its cost
      ledger record) against the device's peak for the state's dtype
      (``telemetry.peak_flops_estimate``: the H100's published peaks on
      the card, a rough per-core rule on the CPU).
    - **byte roofline**: the bucket's analytic bytes per row against the
      device's memory rate (``telemetry.peak_bandwidth_estimate``; none on
      the CPU).

    Fleet prediction = healthy replicas × per-replica ceiling (routing
    spreads keys uniformly). Returns the inputs beside the prediction."""
    from fm_returnprediction_tpu_torch import telemetry
    from fm_returnprediction_tpu_torch.serving.supervisor import HEALTHY

    with fleet._lock:
        reps = [r for r in fleet._replicas.values() if r.state == HEALTHY]
    if not reps:
        raise RuntimeError("capacity_model needs at least one healthy replica")
    rep = reps[0]
    executor = rep.service.executor
    bucket = max(executor.buckets())
    state = rep.service.state
    have = np.nonzero(state.have_coef())[0]
    month = int(have[0]) if len(have) else 0
    months = np.full(bucket, month, dtype=np.int64)
    lo = np.where(np.isfinite(state.x_lo[month]), state.x_lo[month], -1.0)
    x = np.tile(lo.astype(state.dtype), (bucket, 1))
    valid = np.ones(bucket, dtype=bool)
    executor.run(months, x, valid)  # warm the path outside the timing
    t0 = time.perf_counter()
    for _ in range(probe_repeats):
        executor.run(months, x, valid)  # returns host numpy: synchronized
    dispatch_s = (time.perf_counter() - t0) / probe_repeats
    max_latency_s = float(
        fleet._service_kwargs.get("max_latency_ms", 2.0)
    ) / 1e3
    per_replica_dispatch = bucket / max(dispatch_s, max_latency_s)
    flops_per_row = bytes_per_row = None
    roofline_rows_per_s = None
    for rec in reversed(telemetry.cost_ledger().records()):
        if rec.program == "serving_bucket" and rec.bucket == bucket and rec.flops:
            flops_per_row = rec.flops / bucket
            bytes_per_row = (rec.bytes_accessed or 0.0) / bucket
            peak = telemetry.peak_flops_estimate(np.dtype(state.dtype).name)
            roofline_rows_per_s = peak / max(flops_per_row, 1e-12)
            rate = telemetry.peak_bandwidth_estimate()
            if rate and bytes_per_row:
                roofline_rows_per_s = min(roofline_rows_per_s, rate / bytes_per_row)
            break
    per_replica = per_replica_dispatch
    if roofline_rows_per_s is not None:
        per_replica = min(per_replica, roofline_rows_per_s)
    return {
        "bucket": int(bucket),
        "dispatch_s": round(dispatch_s, 6),
        "max_latency_s": max_latency_s,
        "flops_per_row": flops_per_row,
        "bytes_per_row": bytes_per_row,
        "roofline_rows_per_s": (round(roofline_rows_per_s, 1)
                                if roofline_rows_per_s else None),
        "predicted_rows_per_s_per_replica": round(per_replica, 1),
        "healthy_replicas": len(reps),
        "predicted_rows_per_s": round(per_replica * len(reps), 1),
    }
