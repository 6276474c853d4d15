"""The port's online E[r] service (``ERService(device="cpu")``) vs the JAX
package's, and vs the port's own batch forecast, at float64.

Same seeded numpy panel on both sides (120 months × 80 firms × 3
predictors, ``tests/test_serving.py``'s shape):

- the JAX ``ERService`` on the JAX state and the port's on the same state
  (converted leaf by leaf) answer the same 400 firm-month queries to rtol
  1e-12 with the NaN pattern exact (``max_batch=16`` keeps the JAX
  compiles few);
- a microbatched stream from four threads matches the port's batch
  ``rolling_er_forecast`` at the reference's pins (rtol 1e-9, atol 1e-12,
  the same NaN pattern), incomplete rows and months before
  ``min_periods`` come back NaN, a row with no realized return is quoted,
  an unknown month raises;
- a 1k-query stream of mixed bursts after ``warmup()`` builds nothing;
- ``ingest_month`` through the service, a poisoned month quarantined at
  the ``serving.ingest`` site (``poison_nan_flood``) with the service still
  quoting from its last-known-good state, a heal, ``swap_state``, a
  stalled dispatch failed by the watchdog, and ``kill``: each against the
  JAX service's behaviour on the same inputs;
- ``device=None`` without a GPU raises.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from fm_returnprediction_tpu.resilience.faults import FaultSpec as JaxFaultSpec
from fm_returnprediction_tpu.resilience.faults import poison_nan_flood as jax_poison
from fm_returnprediction_tpu.serving import ERService as JaxService
from fm_returnprediction_tpu.serving import build_serving_state as jax_build
from fm_returnprediction_tpu_torch.models.forecast import rolling_er_forecast
from fm_returnprediction_tpu_torch.resilience.errors import (
    DispatchTimeoutError,
    ReplicaDeadError,
)
from fm_returnprediction_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    poison_nan_flood,
)
from fm_returnprediction_tpu_torch.serving import (
    ERService,
    ServingState,
    build_serving_state,
    ingest_month,
)

pytestmark = pytest.mark.torch_port

WINDOW, MIN_PERIODS = 40, 20
T = torch.from_numpy


def _make_panel(seed=2015, t=120, n=80, p=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    y = x @ (0.05 * np.array([1.0, -0.5, 0.25])[:p]) + 0.02 * rng.standard_normal((t, n))
    mask = rng.random((t, n)) > 0.1
    y = np.where(mask, y, np.nan)
    x = np.where(mask[..., None], x, np.nan)
    holes = rng.random((t, n)) < 0.05          # incomplete predictors inside the mask
    x[..., 0] = np.where(holes & mask, np.nan, x[..., 0])
    return y, x, mask


def _to_port(jax_state) -> ServingState:
    return ServingState(**{f.name: getattr(jax_state, f.name)
                           for f in dataclasses.fields(ServingState)})


@pytest.fixture(scope="module")
def case():
    y, x, mask = _make_panel()
    fr = rolling_er_forecast(T(y), T(x), T(mask), window=WINDOW, min_periods=MIN_PERIODS)
    state = build_serving_state(T(y), T(x), T(mask), window=WINDOW, min_periods=MIN_PERIODS)
    return y, x, mask, fr.er.numpy(), fr.slopes_bar.numpy(), state


@pytest.fixture(scope="module")
def jax_state(case):
    y, x, mask, *_ = case
    return jax_build(y, x, mask, window=WINDOW, min_periods=MIN_PERIODS)


def _pairs(seed, t, n, k):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, t)), int(rng.integers(0, n))) for _ in range(k)]


def test_state_matches_batch_artifacts(case):
    *_, slopes_bar, state = case
    np.testing.assert_allclose(state.slopes_bar, slopes_bar, rtol=1e-12, equal_nan=True)
    assert state.coef.shape == (120, 4) and state.gram.shape == (120, 4, 4)


def test_service_matches_the_jax_service_row_for_row(case, jax_state):
    """The same queries through both services, on the same state: per-row
    E[r] at rtol 1e-12, the NaN pattern exact, both warm with no build
    at query time."""
    _, x, _, er, _, _ = case
    pairs = _pairs(7, *er.shape, 400)
    months = [tt for tt, _ in pairs]
    rows = [x[tt, i] for tt, i in pairs]
    with JaxService(jax_state, max_batch=16, max_latency_ms=1.0) as jsvc:
        want = jsvc.query_many(months, rows)
        jstats = jsvc.stats()
    with ERService(_to_port(jax_state), max_batch=16, max_latency_ms=1.0,
                   device="cpu") as svc:
        got = svc.query_many(months, rows)
        stats = svc.stats()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)
    assert np.isfinite(got).sum() > 200
    assert set(stats) == set(jstats)
    assert stats["executable_cache_misses"] == jstats["executable_cache_misses"] == 0
    assert stats["executable_compiles"] == jstats["executable_compiles"] == 5


def test_microbatched_stream_matches_batch_forecast(case):
    """Random single-firm queries from four threads, coalesced by the live
    batcher, equal the port's batch projection: NaN rows included."""
    _, x, _, er, _, state = case
    pairs = _pairs(7, *er.shape, 400)
    got = np.empty(len(pairs))
    with ERService(state, max_batch=32, max_latency_ms=1.0, device="cpu") as svc:
        def worker(lo, hi):
            for k in range(lo, hi):
                tt, i = pairs[k]
                got[k] = svc.query(tt, x[tt, i])

        threads = [threading.Thread(target=worker, args=(k * 100, (k + 1) * 100))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        stats = svc.stats()
    want = np.array([er[tt, i] for tt, i in pairs])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12, equal_nan=True)
    assert stats["n_done"] == len(pairs)
    assert stats["executable_cache_misses"] == 0


def test_incomplete_predictors_return_nan(case):
    _, x, _, er, _, state = case
    with ERService(state, max_batch=8, max_latency_ms=0.5, device="cpu") as svc:
        t_q = 100
        nan_rows = np.nonzero(~np.isfinite(er[t_q]))[0]
        assert len(nan_rows)
        for i in nan_rows[:5]:
            assert np.isnan(svc.query(t_q, x[t_q, i]))
        assert np.isnan(svc.query(t_q, np.full(state.n_predictors, np.nan)))


def test_serving_answers_rows_with_missing_realized_return(case, jax_state):
    """The reference's deliberate superset: a features-complete row with
    no realized return is quoted, as the JAX service quotes it."""
    _, x, _, _, _, state = case
    t_q = 110
    x_row = np.where(np.isfinite(x[t_q, 0]), x[t_q, 0], 0.0)
    expected = state.intercept_bar[t_q] + float(
        np.clip(x_row, state.x_lo[t_q], state.x_hi[t_q]) @ state.slopes_bar[t_q])
    with ERService(state, max_batch=8, max_latency_ms=0.5, device="cpu") as svc:
        got = svc.query(t_q, x_row)
    np.testing.assert_allclose(got, expected, rtol=1e-12)
    with JaxService(jax_state, max_batch=2, max_latency_ms=0.5) as jsvc:
        np.testing.assert_allclose(got, jsvc.query(t_q, x_row), rtol=1e-12)


def test_months_before_min_periods_are_unavailable(case):
    *_, state = case
    assert not state.have_coef()[:MIN_PERIODS].any()
    with ERService(state, max_batch=8, max_latency_ms=0.5, device="cpu") as svc:
        assert np.isnan(svc.query(0, np.zeros(state.n_predictors)))


def test_unknown_month_raises(case):
    *_, state = case
    with ERService(state, warm=False, auto_flush=False, device="cpu") as svc:
        with pytest.raises(KeyError):
            svc.query(np.datetime64("1901-01-01"), np.zeros(3))
        with pytest.raises(KeyError):
            svc.query(10_000, np.zeros(3))
        (kind, err), = svc.submit_many([(10_000, np.zeros(3))])
        assert kind == "err" and isinstance(err, KeyError)


def test_no_compiles_after_warmup_over_1k_query_stream(case):
    """A 1k-query stream in bursts of 1–49 hits a built bucket on every
    dispatch after warm-up (the service's own counters)."""
    _, x, _, er, _, state = case
    rng = np.random.default_rng(11)
    t, n = er.shape
    with ERService(state, max_batch=32, max_latency_ms=0.2, device="cpu") as svc:
        warm = svc.executor.compiles
        assert warm == len(svc.executor.buckets()) and svc.executor.misses == 0
        served = 0
        while served < 1000:
            k = int(rng.integers(1, 50))
            months, rows = rng.integers(0, t, k), rng.integers(0, n, k)
            got = svc.query_many(list(months), [x[tt, i] for tt, i in zip(months, rows)])
            want = er[months, rows]
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12, equal_nan=True)
            served += k
        stats = svc.stats()
    assert stats["n_done"] == served >= 1000
    assert stats["executable_cache_misses"] == 0
    assert svc.executor.compiles == warm
    assert stats["executable_cache_hits"] == stats["n_batches"] > 0


def test_ingest_quarantine_and_heal_match_the_jax_service(case):
    """``ingest_month`` through both services: a poisoned month (the
    ``poison_nan_flood`` mutator at ``serving.ingest``) is quarantined
    under the same rule, both keep quoting the same value from their
    last-known-good state, the clean month then ingests, heals the
    quarantine and quotes the same value in both."""
    y, x, mask, *_ = case
    t0 = 100
    jax_st = jax_build(y[:t0], x[:t0], mask[:t0], window=WINDOW, min_periods=MIN_PERIODS,
                       solver="normal")
    month = np.datetime64(t0, "M")
    i = int(np.nonzero(np.isfinite(x[t0 - 1]).all(1) & np.isfinite(x[t0]).all(1))[0][0])
    out = {}
    for name, svc, plan, spec, poison in (
            ("jax", JaxService(jax_st, max_batch=4), JaxFaultPlan, JaxFaultSpec, jax_poison),
            ("port", ERService(_to_port(jax_st), max_batch=4, device="cpu"), FaultPlan,
             FaultSpec, poison_nan_flood)):
        with svc:
            before = svc.query(t0 - 1, x[t0 - 1, i])
            with plan({"serving.ingest": spec(times=1, mutate=poison)}):
                poisoned = svc.ingest_month(y[t0], x[t0], mask[t0], month)
            reason = svc.quarantined_months()[str(np.datetime64(month, "ns"))]
            still = svc.query(t0 - 1, x[t0 - 1, i])
            n_before = svc.state.n_months
            healed = svc.ingest_month(y[t0], x[t0], mask[t0], month)
            stats = svc.stats()
            out[name] = dict(
                before=before, still=still, poisoned=poisoned, reason=reason,
                n_before=n_before, healed=healed, degraded=svc.degraded,
                n_after=svc.state.n_months, quote=svc.query(t0, x[t0, i]),
                audit=svc.audit.names(), ingested=stats["n_ingested"],
                failed=stats["n_ingest_failed"], misses=stats["executable_cache_misses"])
    jx, pt = out["jax"], out["port"]
    assert not pt["poisoned"] and not jx["poisoned"]
    assert "cs.nan_flood" in pt["reason"] and "cs.nan_flood" in jx["reason"]
    assert np.isfinite(pt["before"]) and np.isfinite(pt["quote"])
    assert pt["still"] == pt["before"] and pt["n_before"] == t0
    assert pt["healed"] and jx["healed"] and not pt["degraded"]
    assert pt["n_after"] == jx["n_after"] == t0 + 1
    assert (pt["ingested"], pt["failed"], pt["misses"]) == (jx["ingested"], jx["failed"], 0)
    assert pt["audit"] == jx["audit"]
    np.testing.assert_allclose(pt["before"], jx["before"], rtol=1e-12)
    np.testing.assert_allclose(pt["quote"], jx["quote"], rtol=1e-9, atol=1e-12)


def test_swap_state_publishes_behind_a_warm_executor(case):
    """``swap_state`` flips to an externally built state with its buckets
    already built (no miss after the swap) and old months' answers
    unchanged; counters survive the swap."""
    y, x, mask, *_ = case
    base = build_serving_state(T(y[:-1]), T(x[:-1]), T(mask[:-1]), window=WINDOW,
                               min_periods=MIN_PERIODS, solver="normal")
    grown = ingest_month(base, y[-1], x[-1], mask[-1], np.datetime64(119, "M"), device="cpu")
    with ERService(base, max_batch=8, auto_flush=False, device="cpu") as svc:
        fut = svc.submit(100, x[100, 2])
        svc.batcher.drain()
        before = fut.result(timeout=5)
        svc.swap_state(grown)
        assert svc.state is grown
        futs = [svc.submit(m, x[m, 2]) for m in (100, 119)]
        svc.batcher.drain()
        after, last = (f.result(timeout=5) for f in futs)
        stats = svc.stats()
    assert after == before and np.isfinite(last)
    assert stats["executable_cache_misses"] == 0
    assert stats["executable_compiles"] == 2 * len(svc.executor.buckets())
    assert stats["executable_cache_hits"] == 2


def test_stalled_dispatch_fails_its_batch_and_the_service_lives_on(case):
    """The watchdog: a dispatch stalled at ``serving.dispatch`` fails its
    own batch with ``DispatchTimeoutError``; the next query succeeds."""
    _, x, _, _, _, state = case
    row = x[110, int(np.nonzero(np.isfinite(x[110]).all(1))[0][0])]
    with ERService(state, max_batch=8, max_latency_ms=0.5, dispatch_timeout_s=0.25,
                   device="cpu") as svc:
        with FaultPlan({"serving.dispatch": FaultSpec(times=1, delay_s=1.0)}):
            fut = svc.submit(110, row)
            with pytest.raises(DispatchTimeoutError):
                fut.result(timeout=10.0)
        assert np.isfinite(svc.query(110, row, timeout=10.0))
        stats = svc.stats()
    # the abandoned worker wakes after its stall and finishes on its own
    for th in threading.enumerate():
        if th.name == "fmrp-serving-dispatch":
            th.join(timeout=10.0)
            assert not th.is_alive()
    assert stats["dispatch_timeouts"] == 1
    assert stats["n_failed"] == 1 and stats["n_failed_batches"] == 1


def test_kill_fails_queued_requests(case):
    *_, state = case
    svc = ERService(state, max_batch=8, auto_flush=False, device="cpu")
    futs = [svc.submit(110, np.zeros(3)) for _ in range(3)]
    assert svc.kill("test") == 3
    for fut in futs:
        with pytest.raises(ReplicaDeadError):
            fut.result(timeout=1)
    with pytest.raises(RuntimeError):
        svc.submit(110, np.zeros(3))
    svc.close()


def test_service_defaults_to_the_gpu(case, monkeypatch):
    *_, state = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ERService(state)
