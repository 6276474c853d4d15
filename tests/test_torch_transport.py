"""The port's shared-memory data plane on the CPU, held to
``tests/test_transport.py``'s contracts, case for case, plus the byte
equality of the two packages' frames.

- **The ring.** The seq/commit protocol (order, wraparound), torn frames
  reading as absent, ring-full backpressure as a typed stall then error,
  an oversized frame refused.
- **The frame grammar.** Submit/ack/result round trips, the cold paths
  (non-int months, pickled rows, exception tails) and the
  ``DegradedQuote`` disclosure columns; the port packs the same bytes as
  the JAX package for the same rows, and each package decodes the
  other's frames.
- **The fleet data plane.** Thread, socket and shm fleets quote the same
  bits; ring-full surfaces as the retriable ``ServiceOverloadError``; the
  journal replays clean through a ``hard_crash`` on the shm path.
- **The grid data plane.** Mapped-segment stats equal the pickled frames
  bit for bit, with the exchange's byte bill collapsed; an explicit
  ``shm`` whose segments do not fit ``/dev/shm`` raises before anything
  is written, and ``auto`` then resolves to ``frames``.
"""

from __future__ import annotations

import struct
import threading
import time

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu_torch.parallel import shm as pshm
from fm_returnprediction_tpu_torch.parallel.shm import (
    HEADER_BYTES,
    RingFullError,
    ShmRing,
    attach_ring,
    shm_available,
    transport_instruments,
)
from fm_returnprediction_tpu_torch.serving import shm as fleet_shm

pytestmark = [
    pytest.mark.torch_port,
    pytest.mark.transport,
    pytest.mark.skipif(not shm_available(), reason="POSIX shared memory unavailable here"),
]


# -- the ring ---------------------------------------------------------------


def test_ring_roundtrip_order_and_wraparound():
    ring = ShmRing(create=True, slots=8, slot_bytes=256)
    try:
        reader = attach_ring(ring.name)
        payloads = [f"frame-{i}".encode() * (i % 3 + 1) for i in range(13)]
        got = []
        for i, p in enumerate(payloads):
            ring.send(p, timeout_s=1.0)
            if i % 2:
                got.append(reader.recv(timeout_s=1.0))
        while len(got) < len(payloads):
            got.append(reader.recv(timeout_s=1.0))
        assert got == payloads
        reader.close()
    finally:
        ring.close()


def test_torn_frame_reads_as_absent_until_committed():
    ring = ShmRing(create=True, slots=4, slot_bytes=256)
    try:
        reader = attach_ring(ring.name)
        payload = b"half-written"
        off = HEADER_BYTES  # slot 0 = seq 1
        ring._buf[off + 16:off + 16 + len(payload)] = payload
        struct.pack_into("<I", ring._buf, off + 8, len(payload))
        assert reader.recv(timeout_s=0.05) is None
        struct.pack_into("<Q", ring._buf, off, 1)
        assert reader.recv(timeout_s=1.0) == payload
        reader.close()
    finally:
        ring.close()


def test_ring_full_stalls_then_raises_typed():
    inst = transport_instruments("shm", "ringtest")
    stalls0 = inst["stalls"].value
    ring = ShmRing(create=True, slots=2, slot_bytes=128, instruments=inst)
    try:
        ring.send(b"a", timeout_s=0.2)
        ring.send(b"b", timeout_s=0.2)
        t0 = time.monotonic()
        with pytest.raises(RingFullError):
            ring.send(b"c", timeout_s=0.08)
        assert time.monotonic() - t0 >= 0.07
        assert inst["stalls"].value == stalls0 + 1
    finally:
        ring.close()


def test_oversized_frame_rejected():
    ring = ShmRing(create=True, slots=2, slot_bytes=64)
    try:
        with pytest.raises(ValueError):
            ring.send(b"x" * 256, timeout_s=0.1)
    finally:
        ring.close()


# -- the frame grammar ------------------------------------------------------


def test_submit_frame_roundtrip_hot_and_cold_paths():
    rows = [
        (1, 7, np.arange(4, dtype=np.float32)),
        (2, 9, np.arange(3, dtype=np.float64) * 1.5),
        (3, "2001-01", np.ones(2, dtype=np.float32)),
        (4, 11, [1.0, 2.0]),
    ]
    kind, back = fleet_shm.unpack_frame(fleet_shm.pack_submit(rows))
    assert kind == fleet_shm.KIND_SUBMIT
    for (rid, month, x), (rid2, month2, x2) in zip(rows, back):
        assert rid2 == rid and month2 == month
        if isinstance(x, np.ndarray):
            assert x2.dtype == x.dtype and np.array_equal(x2, x)
        else:
            assert x2 == x


def test_submit_frame_single_row_fast_path_matches_layout():
    row = np.arange(5, dtype=np.float32)
    kind, back = fleet_shm.unpack_frame(fleet_shm.pack_submit([(42, 13, row)]))
    assert kind == fleet_shm.KIND_SUBMIT
    (rid, month, x), = back
    assert (rid, month) == (42, 13)
    assert x.dtype == np.float32 and np.array_equal(x, row)


def test_ack_and_result_frame_roundtrip_with_degraded_columns():
    from fm_returnprediction_tpu_torch.serving.brownout import DegradedQuote

    ack = fleet_shm.pack_ack(
        [5, 6], [fleet_shm.STATUS_QUEUE_FULL, fleet_shm.STATUS_ERROR],
        {0: {"message": "full", "queue_depth": 3, "max_queue": 4},
         1: {"exc": None, "error": "KeyError(99)"}})
    kind, rows = fleet_shm.unpack_frame(ack)
    assert kind == fleet_shm.KIND_ACK
    assert rows[0][:2] == (5, fleet_shm.STATUS_QUEUE_FULL)
    assert rows[0][2]["queue_depth"] == 3
    assert rows[1][2]["error"] == "KeyError(99)"
    dq = DegradedQuote(0.25, route="coreset", precision="f32", m=8, err_bound=0.125)
    kind, rows = fleet_shm.unpack_frame(fleet_shm.pack_results(
        [(7, True, 0.5), (8, True, dq), (9, False, KeyError(123))]))
    assert kind == fleet_shm.KIND_RESULT
    assert rows[0] == (7, True, 0.5)
    rid, ok, val = rows[1]
    assert ok and float(val) == 0.25 and isinstance(val, DegradedQuote)
    assert (val.route, val.precision, val.m, val.err_bound) == ("coreset", "f32", 8, 0.125)
    rid, ok, payload = rows[2]
    assert not ok and "KeyError" in payload["error"]


def test_result_frame_all_ok_fast_path():
    kind, rows = fleet_shm.unpack_frame(
        fleet_shm.pack_results([(i, True, float(i) / 7) for i in range(9)]))
    assert rows == [(i, True, float(i) / 7) for i in range(9)]


def test_frames_are_byte_equal_to_the_reference_packages():
    """The same rows pack to the same bytes in both packages (telemetry
    unarmed, so the header stamps are zeros on both sides), and each
    package's ``unpack_frame`` decodes the other's frames to the same
    rows, hot paths, cold tails and disclosure columns included."""
    from fm_returnprediction_tpu.serving import shm as jshm
    from fm_returnprediction_tpu.serving.brownout import DegradedQuote as JaxQuote
    from fm_returnprediction_tpu_torch.serving.brownout import DegradedQuote

    rng = np.random.default_rng(5)
    submits = [
        [(42, 13, rng.standard_normal(6).astype(np.float32))],
        [(i, 7 + i, rng.standard_normal(6).astype(np.float32)) for i in range(17)],
        [(1, 7, np.arange(4, dtype=np.float32)), (2, 9, np.arange(3, dtype=np.float64)),
         (3, "2001-01", np.ones(2, np.float32)), (4, 11, [1.0, 2.0])],
    ]
    for rows in submits:
        assert fleet_shm.pack_submit(rows) == jshm.pack_submit(rows)
        for unpack in (fleet_shm.unpack_frame, jshm.unpack_frame):
            kind, back = unpack(jshm.pack_submit(rows))
            assert kind == fleet_shm.KIND_SUBMIT == jshm.KIND_SUBMIT
            for (rid, m, x), (rid2, m2, x2) in zip(rows, back):
                assert (rid2, m2) == (rid, m)
                assert (np.array_equal(x2, x) if isinstance(x, np.ndarray) else x2 == x)
    ev = {0: {"message": "full", "queue_depth": 3, "max_queue": 4}}
    assert fleet_shm.pack_ack([5, 6], [1, 0], ev) == jshm.pack_ack([5, 6], [1, 0], ev)
    assert fleet_shm.pack_ack([7], [0]) == jshm.pack_ack([7], [0])
    values = [(i, True, float(v)) for i, v in enumerate(rng.standard_normal(33))]
    assert fleet_shm.pack_results(values) == jshm.pack_results(values)
    port_res = fleet_shm.pack_results(
        [(1, True, DegradedQuote(0.25, route="bf16", precision="bf16", m=None, err_bound=0.5))])
    jax_res = jshm.pack_results(
        [(1, True, JaxQuote(0.25, route="bf16", precision="bf16", m=None, err_bound=0.5))])
    assert port_res == jax_res
    for frame in (port_res, jax_res):
        (_, _, val), = fleet_shm.unpack_frame(frame)[1]
        assert isinstance(val, DegradedQuote) and (val.route, val.err_bound) == ("bf16", 0.5)
        (_, _, jval), = jshm.unpack_frame(frame)[1]
        assert isinstance(jval, JaxQuote) and float(jval) == float(val)


# -- channel backpressure ---------------------------------------------------


def test_channel_ring_full_surfaces_typed_retriable_overload():
    from fm_returnprediction_tpu_torch.resilience.errors import ServiceOverloadError

    acks = []
    inst = transport_instruments("shm", "chantest")
    stalls0 = inst["stalls"].value
    chan = fleet_shm.ShmReplicaChannel(
        on_ack=lambda rid, st, ev: acks.append((rid, st, ev)),
        on_results=lambda rows: None, on_dead=lambda why: None,
        replica_id="chantest", slots=2, slot_bytes=2048, send_timeout_s=0.05,
        instruments=inst)
    try:
        row = np.ones(4, dtype=np.float32)
        for i in range(3):
            chan.submit_row(i, 0, row)
        assert len(acks) >= 1
        _, _, ev = acks[-1]
        exc = ev["overload"]
        assert isinstance(exc, ServiceOverloadError)
        assert exc.reason == "transport_ring_full" and exc.retry_after_s > 0
        assert inst["stalls"].value > stalls0
    finally:
        chan.stop()


# -- in-process data-plane serve loop ---------------------------------------


def _tiny_state(t=36, n=80, p=4, seed=3):
    from fm_returnprediction_tpu_torch.serving import build_serving_state

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p)).astype(np.float32)
    beta = (rng.standard_normal(p) * 0.05).astype(np.float32)
    y = (x @ beta + 0.1 * rng.standard_normal((t, n))).astype(np.float32)
    mask = rng.random((t, n)) > 0.2
    y = np.where(mask, y, np.nan).astype(np.float32)
    state = build_serving_state(torch.from_numpy(y), torch.from_numpy(x),
                                torch.from_numpy(mask), window=t // 2, min_periods=t // 4)
    return state, np.nonzero(state.have_coef())[0], rng


def test_serve_data_plane_in_process_and_torn_strip_ignored():
    from fm_returnprediction_tpu_torch.serving.service import ERService

    state, months, rng = _tiny_state()
    service = ERService(state, max_batch=8, max_latency_ms=0.5, device="cpu")
    req = ShmRing(create=True, slots=8, slot_bytes=4096)
    resp = ShmRing(create=True, slots=8, slot_bytes=4096)
    stop = threading.Event()
    th = threading.Thread(target=fleet_shm.serve_data_plane,
                          args=(service, attach_ring(req.name), attach_ring(resp.name), stop),
                          daemon=True)
    th.start()
    try:
        month = int(months[0])
        row = rng.standard_normal(4).astype(np.float32)
        want = service.query(month, row)
        req.send(fleet_shm.pack_submit([(1, month, row)]), timeout_s=1.0)
        frame = resp.recv(timeout_s=5.0)
        assert frame is not None
        kind, rows = fleet_shm.unpack_frame(frame)
        assert kind == fleet_shm.KIND_RESULT
        assert rows[0][0] == 1 and rows[0][1] is True and rows[0][2] == want
        # a poison row fails alone; its strip-mate still gets its quote
        req.send(fleet_shm.pack_submit([(2, month, [[1.0, 2.0], [3.0]]), (3, month, row)]),
                 timeout_s=1.0)
        got = {}
        while len(got) < 2:
            frame = resp.recv(timeout_s=5.0)
            assert frame is not None
            kind, frame_rows = fleet_shm.unpack_frame(frame)
            for rid, a, b in frame_rows:
                got[rid] = (kind, a, b)
        assert got[3] == (fleet_shm.KIND_RESULT, True, want)
        kind2, status2, ev2 = got[2]
        assert kind2 == fleet_shm.KIND_ACK and status2 == fleet_shm.STATUS_ERROR
        assert "array-like" in ev2["error"] or "1-D" in ev2["error"]
        # a torn strip (commit word never written) is absent
        payload = fleet_shm.pack_submit([(4, month, row)])
        off = req._slot_off(req._wseq + 1)
        req._buf[off + 16:off + 16 + len(payload)] = payload
        struct.pack_into("<I", req._buf, off + 8, len(payload))
        assert resp.recv(timeout_s=0.3) is None
    finally:
        stop.set()
        th.join(timeout=5)
        assert not th.is_alive()
        service.close()
        req.close()
        resp.close()


# -- batch submit (the serve loop's absorption path) -------------------------


def test_batcher_submit_many_matches_submit_semantics():
    from fm_returnprediction_tpu_torch.serving.batcher import MicroBatcher, QueueFullError

    b = MicroBatcher(lambda m, x, v: np.asarray(m, np.float64), max_batch=4,
                     max_latency_ms=50.0, max_queue=3, auto_flush=False, n_predictors=3)
    rows = [(0, np.ones(3, np.float32)), (1, np.ones(2, np.float32)),
            (2, np.ones(3, np.float32)), (3, np.ones(3, np.float32)),
            (4, np.ones(3, np.float32))]
    out = b.submit_many(rows)
    assert [k for k, _ in out] == ["ok", "err", "ok", "ok", "err"]
    assert isinstance(out[1][1], ValueError)
    assert isinstance(out[4][1], QueueFullError) and out[4][1].max_queue == 3
    b.drain()
    assert [out[i][1].result(timeout=5) for i in (0, 2, 3)] == [0, 2, 3]
    b.close()


def test_service_submit_many_unknown_month_fails_alone():
    from fm_returnprediction_tpu_torch.serving.service import ERService

    state, months, rng = _tiny_state()
    service = ERService(state, max_batch=8, auto_flush=False, device="cpu")
    try:
        row = rng.standard_normal(4).astype(np.float32)
        out = service.submit_many([(int(months[0]), row), (10 ** 9, row),
                                   (int(months[-1]), row)])
        assert [k for k, _ in out] == ["ok", "err", "ok"]
        assert isinstance(out[1][1], KeyError)
        service.batcher.drain()
        assert np.isfinite(out[0][1].result(timeout=5))
        assert np.isfinite(out[2][1].result(timeout=5))
    finally:
        service.close()


# -- the process fleet over both transports ---------------------------------


def test_fleet_quotes_bit_identical_thread_socket_shm(tmp_path):
    """The same queries through thread replicas, a socket process fleet of
    1 and shm process fleets of 1 and 2: every float bit-identical, every
    journal replaying clean."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet, replay_journal

    state, months, rng = _tiny_state(t=48, n=120, p=4)
    k = 24
    qm = months[rng.integers(0, len(months), k)]
    qx = rng.standard_normal((k, 4)).astype(np.float32)
    fleets = (("thread", 1, dict(replica_mode="thread")),
              ("socket1", 1, dict(replica_mode="process", transport="socket")),
              ("shm1", 1, dict(replica_mode="process", transport="shm")),
              ("shm2", 2, dict(replica_mode="process", transport="shm")))
    vals = {}
    for name, n_rep, kw in fleets:
        journal = tmp_path / f"{name}.jsonl"
        fleet = ServingFleet(state, n_rep, max_batch=16, max_latency_ms=1.0, journal=journal,
                             device="cpu", **kw)
        try:
            if kw["replica_mode"] == "process":
                assert fleet.stats()["transport"] == kw["transport"]
            vals[name] = np.asarray([fleet.query(int(m), r) for m, r in zip(qm, qx)])
        finally:
            fleet.close()
        assert replay_journal(journal).clean, name
    assert np.isfinite(vals["thread"]).all()
    for name in ("socket1", "shm1", "shm2"):
        assert np.array_equal(vals["thread"], vals[name]), name


def test_shm_fleet_hard_crash_journal_replays_clean(tmp_path):
    """Requests in flight on the shm rings, the router hard-crashes
    (journal abandoned, children killed), and recovery closes the session
    out to a clean replay."""
    from fm_returnprediction_tpu_torch.serving import ServingFleet, replay_journal

    state, months, rng = _tiny_state(t=48, n=120, p=4)
    journal = tmp_path / "crash.jsonl"
    fleet = ServingFleet(state, 2, replica_mode="process", transport="shm", max_batch=16,
                         max_latency_ms=5.0, journal=journal, device="cpu")
    qx = rng.standard_normal((40, 4)).astype(np.float32)
    fleet.query(int(months[0]), qx[0])
    pids = [fleet.replica(r).service.proc for r in fleet.replica_states()]
    futs = [fleet.submit(int(months[i % len(months)]), qx[i]) for i in range(40)]
    fleet.hard_crash()
    del futs
    assert all(p.poll() is not None for p in pids), "the crashed fleet's children are reaped"
    assert not replay_journal(journal).clean
    recovered, report = ServingFleet.recover(journal, state=state, replica_mode="thread",
                                             max_batch=16, auto_flush=False, device="cpu")
    try:
        assert report.journal.replay_clean
        assert len(report.journal.recovered) > 0
        assert replay_journal(journal).clean
        assert report.rotated_to is not None
        rotated = replay_journal(report.rotated_to)
        assert rotated.clean and not rotated.dropped and not rotated.duplicated
        f = recovered.submit(int(months[0]), qx[0])
        recovered.flush_all()
        assert np.isfinite(f.result(timeout=5))
    finally:
        recovered.close()


# -- the multiproc grid over both transports --------------------------------


def _grid_inputs():
    rng = np.random.default_rng(7)
    t, n, p = 24, 64, 6
    y = np.where(rng.random((t, n)) > 0.2, rng.standard_normal((t, n)), np.nan).astype(np.float32)
    x = rng.standard_normal((t, n, p)).astype(np.float32)
    x[rng.random((t, n, p)) < 0.05] = np.nan
    universes = rng.random((2, t, n)) > 0.3
    col_sel = np.zeros((3, p), bool)
    col_sel[0, :3] = True
    col_sel[1, :5] = True
    col_sel[2, :] = True
    return y, x, universes, np.array([0, 1, 0]), col_sel, np.ones((3, t), bool)


def test_multiproc_grid_shm_vs_frames_bit_identical():
    """Mapped-segment stats equal the pickled frames (the same rank-ordered
    fold), a warm second call equals the first, and the exchange's byte
    bill drops by at least 5×."""
    from fm_returnprediction_tpu_torch.specgrid.multiproc import SpecGridWorkerPool

    y, x, universes, uidx, col_sel, window = _grid_inputs()
    stats, merge_bytes = {}, {}
    for transport in ("frames", "shm"):
        pool = SpecGridWorkerPool(2, y, x, universes, transport=transport, device="cpu")
        try:
            s1 = pool.contract(uidx, col_sel, window)
            s2 = pool.contract(uidx, col_sel, window)
            for a, b in zip(s1, s2):
                assert np.array_equal(a, b, equal_nan=True)
            stats[transport] = s1
            merge_bytes[transport] = pool.last_merge_bytes
            if transport == "shm":
                assert pool.last_shm_bytes > 0
        finally:
            pool.close()
    for a, b in zip(stats["frames"], stats["shm"]):
        assert np.array_equal(a, b, equal_nan=True)
    assert merge_bytes["shm"] * 5 <= merge_bytes["frames"]
    assert pshm.owned_segments() == ()


def test_explicit_shm_without_room_raises_before_writing(monkeypatch):
    """A ``/dev/shm`` too small for the panel: ``publish_array`` raises
    ``ShmCapacityError`` naming the size before creating a segment, an
    explicit ``shm`` pool fails before it spawns anything, and ``auto``
    resolves to ``frames``."""
    from fm_returnprediction_tpu_torch.specgrid import multiproc

    y, x, universes, *_ = _grid_inputs()
    monkeypatch.setattr(pshm, "shm_free_bytes", lambda: 4096)
    before = pshm.owned_segments()
    with pytest.raises(pshm.ShmCapacityError, match=f"{x.nbytes:,} bytes"):
        pshm.publish_array(x)
    spawned = []
    monkeypatch.setattr(multiproc.SpecGridWorkerPool, "_spawn_worker",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(pshm.ShmCapacityError):
        multiproc.SpecGridWorkerPool(2, y, x, universes, transport="shm", device="cpu")
    assert spawned == [] and pshm.owned_segments() == before
    assert multiproc.resolve_grid_transport("auto", nbytes=x.nbytes) == "frames"
    assert fleet_shm.resolve_fleet_transport() == "socket"


# -- knob resolution --------------------------------------------------------


def test_transport_resolution_knobs(monkeypatch):
    from fm_returnprediction_tpu_torch.specgrid.multiproc import resolve_grid_transport

    monkeypatch.delenv("FMRP_FLEET_TRANSPORT", raising=False)
    monkeypatch.delenv("FMRP_GRID_TRANSPORT", raising=False)
    assert fleet_shm.resolve_fleet_transport() == "shm"
    assert fleet_shm.resolve_fleet_transport("socket") == "socket"
    assert resolve_grid_transport() == "shm"
    assert resolve_grid_transport("frames") == "frames"
    monkeypatch.setenv("FMRP_FLEET_TRANSPORT", "socket")
    monkeypatch.setenv("FMRP_GRID_TRANSPORT", "frames")
    assert fleet_shm.resolve_fleet_transport() == "socket"
    assert resolve_grid_transport() == "frames"
    assert fleet_shm.resolve_fleet_transport("shm") == "shm"
    assert resolve_grid_transport("shm") == "shm"
    with pytest.raises(ValueError):
        fleet_shm.resolve_fleet_transport("carrier-pigeon")
    with pytest.raises(ValueError):
        resolve_grid_transport("carrier-pigeon")
