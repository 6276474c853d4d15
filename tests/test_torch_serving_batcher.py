"""The port's microbatcher and bucketed executor: the cases of
``tests/test_serving_batcher.py`` on the port, on the CPU.

Bucket ladders equal the JAX package's over a grid of ``(max_batch,
min_bucket)``; padding is an exact no-op on real rows (``array_equal``),
and a bucket's rows equal the JAX executor's at rtol 1e-12; a full queue
raises the documented backpressure error instead of blocking; close
drains or fails what is queued; a malformed row fails alone; a stalled
runner strands nothing; occupancy counts rows per dispatched slot; the
latency deadline flushes a lone request; many producers on a tiny queue
neither deadlock nor lose a request. Every thread is joined with a
timeout, so a regression fails instead of hanging.
"""

import threading
import time

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.serving import build_serving_state as jax_build
from fm_returnprediction_tpu.serving.executor import BucketedExecutor as JaxExecutor
from fm_returnprediction_tpu.serving.executor import bucket_for as jax_bucket_for
from fm_returnprediction_tpu.serving.executor import bucket_sizes as jax_bucket_sizes
from fm_returnprediction_tpu_torch.serving import (
    MicroBatcher,
    QueueFullError,
    build_serving_state,
)
from fm_returnprediction_tpu_torch.serving.executor import (
    BucketedExecutor,
    bucket_for,
    bucket_sizes,
)

pytestmark = pytest.mark.torch_port

T = torch.from_numpy


def _tiny_panel(rng, t=50, n=30, p=2):
    x = rng.standard_normal((t, n, p))
    y = x @ np.array([0.5, -0.25]) + 0.01 * rng.standard_normal((t, n))
    mask = rng.random((t, n)) > 0.1
    y = np.where(mask, y, np.nan)
    x = np.where(mask[..., None], x, np.nan)
    return y, x, mask


def _tiny_state(rng):
    y, x, mask = _tiny_panel(rng)
    return build_serving_state(T(y), T(x), T(mask), window=20, min_periods=10)


# -- bucketing properties --------------------------------------------------


@pytest.mark.parametrize("max_batch", [1, 2, 3, 7, 8, 64, 100, 256])
@pytest.mark.parametrize("min_bucket", [1, 2, 5, 8])
def test_bucket_ladders_equal_the_jax_package(max_batch, min_bucket):
    if min_bucket > 1 << (max_batch - 1).bit_length():
        for fn in (bucket_sizes, jax_bucket_sizes):
            with pytest.raises(ValueError):
                fn(max_batch, min_bucket)
        return
    assert bucket_sizes(max_batch, min_bucket) == jax_bucket_sizes(max_batch, min_bucket)
    for n in range(1, max_batch + 1):
        assert bucket_for(n, max_batch, min_bucket) == jax_bucket_for(n, max_batch, min_bucket)


def test_bucket_ladder_is_powers_of_two():
    for max_batch in (1, 2, 3, 7, 8, 64, 100, 256):
        ladder = bucket_sizes(max_batch)
        assert all(b & (b - 1) == 0 for b in ladder)
        assert ladder[-1] >= max_batch
        assert list(ladder) == sorted(set(ladder))


def test_bucket_choice_is_monotone_and_minimal():
    for max_batch in (8, 64, 100):
        prev = 0
        for n in range(1, max_batch + 1):
            b = bucket_for(n, max_batch)
            assert b >= n and b >= prev
            assert all(r < n for r in bucket_sizes(max_batch) if r < b)
            prev = b


def test_bucket_for_rejects_nonsense():
    with pytest.raises(ValueError):
        bucket_for(0, 8)
    with pytest.raises(ValueError):
        bucket_for(9, 8)
    with pytest.raises(ValueError):
        bucket_for(101, 100)  # the cap is max_batch itself, not the ladder top
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_min_bucket_floors_the_ladder():
    assert bucket_sizes(64, min_bucket=8)[0] == 8
    assert bucket_for(1, 64, min_bucket=8) == 8


# -- padding is an exact no-op --------------------------------------------


def test_padding_never_changes_results(rng):
    """For every batch size 1..16, the same rows through a padded bucket
    give the same bits as the full 16-row bucket."""
    state = _tiny_state(rng)
    exe = BucketedExecutor(state, max_batch=16, device="cpu")
    exe.warmup()
    t = state.n_months
    rows = np.asarray([np.zeros(2) + 0.1 * k for k in range(16)])
    full = exe.run(np.arange(16) % t, rows)
    for size in range(1, 17):
        got = exe.run(np.arange(size) % t, rows[:size])
        np.testing.assert_array_equal(got, full[:size])
    assert exe.misses == 0


def test_bucket_rows_match_the_jax_executor():
    """The same padded batches through the JAX executor and the port's, on
    the same panel: rtol 1e-12, the NaN pattern exact."""
    y, x, mask = _tiny_panel(np.random.default_rng(4))
    port = BucketedExecutor(build_serving_state(T(y), T(x), T(mask), window=20,
                                                min_periods=10), max_batch=8, device="cpu")
    jax_exe = JaxExecutor(jax_build(y, x, mask, window=20, min_periods=10), max_batch=8)
    rng = np.random.default_rng(9)
    for size in (1, 3, 8):
        months = rng.integers(0, 50, size)
        rows = x[months, rng.integers(0, 30, size)]
        got, want = port.run(months, rows), np.asarray(jax_exe.run(months, rows))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


def test_padding_rows_never_leak(rng):
    state = _tiny_state(rng)
    exe = BucketedExecutor(state, max_batch=16, device="cpu")
    out = exe.run(np.asarray([40]), np.asarray([[np.nan, 0.0]]))
    assert out.shape == (1,) and np.isnan(out[0])
    assert exe.misses == 1 and exe.compiles == 1  # built on first use


# -- backpressure ----------------------------------------------------------


def test_full_queue_raises_queue_full_error():
    batcher = MicroBatcher(lambda m, x, v: np.zeros(len(m)),
                           max_batch=4, max_queue=3, auto_flush=False)
    for _ in range(3):
        batcher.submit(0, np.zeros(2))
    with pytest.raises(QueueFullError) as exc:
        batcher.submit(0, np.zeros(2))
    assert exc.value.occupancy == 1.0
    assert batcher.drain() == 3
    batcher.submit(0, np.zeros(2))
    assert batcher.stats()["n_rejected"] == 1


def test_full_queue_raise_does_not_block():
    release = threading.Event()

    def stalled_runner(m, x, v):
        release.wait(10.0)
        return np.zeros(len(m))

    batcher = MicroBatcher(stalled_runner, max_batch=2, max_latency_ms=0.1, max_queue=2,
                           auto_flush=True)
    try:
        outcome = {}

        def producer():
            errors = 0
            for _ in range(50):
                try:
                    batcher.submit(0, np.zeros(2))
                except QueueFullError:
                    errors += 1
            outcome["rejected"] = errors

        th = threading.Thread(target=producer)
        th.start()
        th.join(timeout=5.0)
        assert not th.is_alive(), "submit blocked instead of raising"
        assert outcome["rejected"] > 0
    finally:
        release.set()
        batcher.close()


def test_closed_batcher_rejects():
    batcher = MicroBatcher(lambda m, x, v: np.zeros(len(m)), auto_flush=False)
    batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(0, np.zeros(2))


def test_close_without_flusher_drains_pending():
    batcher = MicroBatcher(lambda m, x, v: np.zeros(len(m)), auto_flush=False)
    fut = batcher.submit(0, np.zeros(2))
    batcher.close()
    assert fut.result(timeout=1.0) == 0.0


def test_malformed_row_fails_alone_not_its_batch():
    batcher = MicroBatcher(lambda m, x, v: np.zeros(len(m)), auto_flush=False,
                           n_predictors=2)
    good = batcher.submit(0, np.zeros(2))
    with pytest.raises(ValueError):
        batcher.submit(0, np.zeros(7))
    with pytest.raises(ValueError):
        batcher.submit(0, np.zeros((2, 2)))
    (k1, f1), (k2, e2) = batcher.submit_many([(0, np.zeros(2)), (0, np.zeros(5))])
    assert k1 == "ok" and k2 == "err" and isinstance(e2, ValueError)
    batcher.flush()
    assert good.result(timeout=1.0) == 0.0 and f1.result(timeout=1.0) == 0.0
    batcher.close()


def test_flusher_survives_errors_and_batches_are_width_homogeneous():
    calls = {"n": 0}

    def picky(m, x, v):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient backend fault")
        if x.shape[1] != 2:
            raise ValueError(f"state expects 2 predictors, got {x.shape[1]}")
        return np.full(len(m), 7.0)

    batcher = MicroBatcher(picky, max_batch=4, max_latency_ms=0.5, auto_flush=True)
    try:
        doomed = batcher.submit(0, np.zeros(2))
        with pytest.raises(RuntimeError, match="transient"):
            doomed.result(timeout=5.0)
        bad = batcher.submit(0, np.zeros(3))
        ok = batcher.submit(0, np.zeros(2))
        with pytest.raises(ValueError, match="2 predictors"):
            bad.result(timeout=5.0)
        assert ok.result(timeout=5.0) == 7.0
    finally:
        batcher.close()


def test_min_bucket_above_max_batch_fails_fast(rng):
    with pytest.raises(ValueError):
        bucket_sizes(4, min_bucket=8)
    with pytest.raises(ValueError):
        BucketedExecutor(_tiny_state(rng), max_batch=4, min_bucket=8, device="cpu")


def test_close_with_stalled_runner_fails_queued_futures():
    release = threading.Event()

    def stalled_runner(m, x, v):
        release.wait(10.0)
        return np.zeros(len(m))

    batcher = MicroBatcher(stalled_runner, max_batch=1, max_latency_ms=0.1, max_queue=8,
                           auto_flush=True)
    try:
        in_flight = batcher.submit(0, np.zeros(2))
        time.sleep(0.05)
        queued = [batcher.submit(0, np.zeros(2)) for _ in range(3)]
        batcher.close(timeout=0.2)
        for fut in queued:
            with pytest.raises(RuntimeError, match="stalled"):
                fut.result(timeout=1.0)
    finally:
        release.set()
    assert in_flight.result(timeout=5.0) == 0.0
    batcher._thread.join(timeout=5.0)
    assert not batcher._thread.is_alive()


def test_occupancy_is_rows_per_dispatched_slot():
    batcher = MicroBatcher(lambda m, x, v: np.zeros(len(m)), max_batch=16, min_bucket=8,
                           auto_flush=False)
    for _ in range(2):
        batcher.submit(0, np.zeros(2))
    batcher.flush()
    assert batcher.stats()["batch_occupancy"] == pytest.approx(2 / 8)
    batcher.close()

    batcher = MicroBatcher(lambda m, x, v: np.zeros(len(m)), max_batch=16, auto_flush=False)
    for _ in range(3):
        batcher.submit(0, np.zeros(2))
    batcher.flush()
    assert batcher.stats()["batch_occupancy"] == pytest.approx(3 / 4)
    batcher.close()


def test_runner_exception_delivered_to_futures():
    def boom(m, x, v):
        raise RuntimeError("backend fault")

    batcher = MicroBatcher(boom, auto_flush=False)
    fut = batcher.submit(0, np.zeros(2))
    batcher.flush()
    with pytest.raises(RuntimeError, match="backend fault"):
        fut.result(timeout=1.0)
    assert batcher.stats()["n_failed_batches"] == 1
    batcher.close()


def test_latency_deadline_flushes_a_lone_request(rng):
    state = _tiny_state(rng)
    exe = BucketedExecutor(state, max_batch=64, device="cpu")
    exe.warmup()
    batcher = MicroBatcher(exe.run, max_batch=64, max_latency_ms=5.0, auto_flush=True)
    try:
        fut = batcher.submit(25, np.zeros(2))
        assert isinstance(fut.result(timeout=5.0), float)
    finally:
        batcher.close()


def test_stress_many_producers_tiny_queue(rng):
    """8 producers hammer a queue of 16 with a slow runner: every submit
    resolves or raises QueueFullError; nothing deadlocks or is lost."""
    state = _tiny_state(rng)
    exe = BucketedExecutor(state, max_batch=8, device="cpu")
    exe.warmup()

    def slow_runner(m, x, v):
        time.sleep(0.002)
        return exe.run(m, x, v)

    batcher = MicroBatcher(slow_runner, max_batch=8, max_latency_ms=0.5, max_queue=16,
                           auto_flush=True)
    done = np.zeros(8, dtype=np.int64)
    rejected = np.zeros(8, dtype=np.int64)

    def producer(k):
        futures = []
        for _ in range(200):
            try:
                futures.append(batcher.submit(25, np.zeros(2)))
            except QueueFullError:
                rejected[k] += 1
        for fut in futures:
            fut.result(timeout=30.0)
        done[k] = len(futures)

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads), "stress run deadlocked"
    stats = batcher.stats()
    batcher.close()
    assert done.sum() + rejected.sum() == 8 * 200
    assert stats["n_done"] == done.sum()
    assert stats["n_rejected"] == rejected.sum()
    assert exe.misses == 0
