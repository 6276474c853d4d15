"""The spawned fleet-replica child (``serving.replica_proc``'s other end).

Usage: ``python -m fm_returnprediction_tpu_torch.serving.replica_worker
<config.pkl>``. Loads its ``ServingState`` bundle from the shared
filesystem, builds the replica service on its device (``cuda`` unless the
spawn config's service arguments say ``device="cpu"``), through the
registry warm pool when the spawn config arms one (the ``WarmReport``
rides back in ``hello``), and answers the router's verbs over the
length-prefixed socket until ``close`` or parent EOF. The service
captures its own bucket graphs: a CUDA graph belongs to one process.

Exactly once: this process journals nothing. The write-ahead journal
belongs to the router; a SIGKILL here tears the socket, the parent fails
the in-flight futures with ``ReplicaDeadError``, and the fleet requeues
them, which is what keeps the replay clean across a replica process
death.
"""

from __future__ import annotations

import os
import pickle
import socket
import sys
import threading
import time
from dataclasses import asdict


def _serve(cfg: dict) -> None:
    from fm_returnprediction_tpu_torch.parallel.distributed import (
        recv_frame,
        send_frame,
    )
    from fm_returnprediction_tpu_torch.resilience.faults import fault_site
    from fm_returnprediction_tpu_torch.telemetry import distributed as _obs
    from fm_returnprediction_tpu_torch.telemetry import spans as _spans

    rid = cfg["rid"]
    sock = socket.create_connection(("127.0.0.1", int(cfg["port"])),
                                    timeout=120.0)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    wlock = threading.Lock()

    def send(msg: dict) -> None:
        send_frame(sock, pickle.dumps(msg), wlock)

    try:
        from fm_returnprediction_tpu_torch.serving.fleet import _ReplicaService
        from fm_returnprediction_tpu_torch.serving.state import ServingState

        state = ServingState.load(cfg["state_path"])
        kwargs = dict(cfg.get("service_kwargs") or {})
        kwargs["metric_labels"] = {"replica": rid}
        kwargs["replica_id"] = rid
        if cfg.get("shm"):
            # the shm data plane already coalesced rows into strips —
            # the batcher's max_latency window would tax every query a
            # second batching wait for batches the transport has formed.
            # Flush immediately: batches = the strips (plus whatever
            # queued during the previous dispatch), latency drops by the
            # window. FMRP_FLEET_SHM_CHILD_LATENCY_MS restores a window.
            kwargs["max_latency_ms"] = float(os.environ.get(
                "FMRP_FLEET_SHM_CHILD_LATENCY_MS", "0") or 0)
        reg_dir = cfg.get("registry_dir")
        warm = None
        if reg_dir:
            from fm_returnprediction_tpu_torch.registry.warm import (
                warm_from_registry,
            )

            service, report = warm_from_registry(
                state=state, registry_dir=reg_dir,
                service_cls=_ReplicaService, **kwargs,
            )
            warm = asdict(report)
        else:
            service = _ReplicaService(state, **kwargs)
    except Exception as exc:  # noqa: BLE001 — the parent needs the why
        send({"op": "hello", "ok": False, "error": repr(exc)[:500]})
        raise
    # anchor_ns is this process's perf_counter→epoch offset: the
    # monotonic-offset exchange that lets the router's timeline merge
    # align every child's spans onto one clock exactly
    send({"op": "hello", "ok": True, "rid": rid, "pid": os.getpid(),
          "warm": warm, "anchor_ns": _spans.EPOCH_ANCHOR_NS})

    # flight annex: attach the parent-owned shm mailbox and mirror the
    # flight tail at every seam — the tail survives SIGKILL there
    annex = None
    if cfg.get("annex"):
        try:
            annex = _obs.FlightAnnex.attach(cfg["annex"])
        except Exception:  # noqa: BLE001 — observability must not kill
            annex = None

    def mirror(reason: str) -> None:
        if annex is None:
            return
        try:
            annex.mirror_flight(reason)
        except Exception:  # noqa: BLE001 — mirrors are best-effort
            pass

    mirror("hello")

    # shm data plane (FMRP_FLEET_TRANSPORT=shm): submits/results ride
    # the rings the parent created; this socket keeps the control verbs
    shm_stop = None
    shm_rings = []
    if cfg.get("shm"):
        from fm_returnprediction_tpu_torch.parallel.shm import attach_ring
        from fm_returnprediction_tpu_torch.serving.shm import serve_data_plane

        req_ring = attach_ring(cfg["shm"]["req"],
                               doorbell_fd=cfg["shm"].get("req_bell"))
        resp_ring = attach_ring(cfg["shm"]["resp"],
                                doorbell_fd=cfg["shm"].get("resp_bell"))
        shm_rings = [req_ring, resp_ring]
        shm_stop = threading.Event()
        send_timeout_s = float(os.environ.get(
            "FMRP_FLEET_SHM_SEND_TIMEOUT_S", "5.0"
        ))
        threading.Thread(
            target=serve_data_plane,
            args=(service, req_ring, resp_ring, shm_stop, send_timeout_s),
            name=f"fmrp-shm-serve-{rid}", daemon=True,
        ).start()

    prepared = {}  # one slot: the fleet serializes rollovers

    def on_done(req_id: int, inner, t_recv: int = 0) -> None:
        exc = inner.exception()
        if t_recv:
            _spans.record_span("hop.solve", t_recv, req=req_id)
        t_send = time.perf_counter_ns() if _spans.active() else 0
        if exc is None:
            # socket-transport seam site: a SIGKILL here dies with the
            # result computed but never sent — the parent's requeue +
            # journal replay must stay clean (the socket twin of the shm
            # path's shm.ring.commit)
            fault_site("replica.result_send")
            msg = {"op": "result", "id": req_id, "ok": True,
                   "value": float(inner.result())}
            if t_send:
                msg["t_ns"] = t_send
            send(msg)
        else:
            try:
                blob = pickle.dumps(exc)
            except Exception:  # noqa: BLE001 — unpicklable: repr travels
                blob = None
            msg = {"op": "result", "id": req_id, "ok": False,
                   "exc": blob, "error": repr(exc)[:300]}
            if t_send:
                msg["t_ns"] = t_send
            send(msg)
        if t_send:
            _spans.record_span("hop.result_send", t_send, req=req_id)
        mirror("result")

    while True:
        try:
            msg = pickle.loads(recv_frame(sock))
        except Exception:  # noqa: BLE001 — parent gone: die quietly
            break
        op, req_id = msg.get("op"), msg.get("id")
        # control-plane chaos site: an env-propagated delay_s here is a
        # HUNG replica (pid alive, verbs not answering) — the liveness
        # ladder must classify it distinctly from killed / ring-stalled
        fault_site("replica.verb", payload=op)
        if op == "submit":
            from fm_returnprediction_tpu_torch.serving.batcher import (
                QueueFullError,
            )

            t_recv = time.perf_counter_ns() if _spans.active() else 0
            if t_recv and msg.get("t_ns"):
                _spans.record_span("hop.transport_req", msg["t_ns"],
                                   t_recv, req=req_id)
            try:
                inner = service.submit(msg["month"], msg["x"])
            except QueueFullError as qe:
                send({"op": "reject", "id": req_id, "kind": "queue_full",
                      "message": str(qe), "queue_depth": qe.queue_depth,
                      "max_queue": qe.max_queue})
                continue
            except RuntimeError as exc:
                send({"op": "reject", "id": req_id, "kind": "closed",
                      "message": str(exc)})
                continue
            except Exception as exc:  # noqa: BLE001 — sync raise travels
                try:
                    blob = pickle.dumps(exc)
                except Exception:  # noqa: BLE001
                    blob = None
                send({"op": "reject", "id": req_id, "kind": "error",
                      "exc": blob, "error": repr(exc)[:300]})
                continue
            send({"op": "accept", "id": req_id})
            inner.add_done_callback(
                lambda fut, i=req_id, t0=t_recv: on_done(i, fut, t0)
            )
            continue
        try:
            if op == "stats":
                value = service.stats()
                if _obs.metrics_enabled():
                    # the heartbeat doubles as the metric-aggregation
                    # wire: ship the registry series that changed
                    value = dict(value)
                    value["metrics_delta"] = _obs.registry_delta()
            elif op == "drain":
                value = service.batcher.drain()
            elif op == "prepare":
                from fm_returnprediction_tpu_torch.serving.state import (
                    ServingState as _SS,
                )

                candidate = _SS.load(msg["state_path"])
                prepared["slot"] = service.prepare_state(candidate)
                value = int(candidate.n_months)
            elif op == "commit":
                service.commit_state(prepared.pop("slot"))
                value = True
            elif op == "ping":
                value = "pong"
            elif op == "close":
                service.close()
                send({"op": "result", "id": req_id, "ok": True,
                      "value": True})
                break
            else:
                raise ValueError(f"unknown verb {op!r}")
            send({"op": "result", "id": req_id, "ok": True, "value": value})
            mirror(f"verb:{op}")
        except Exception as exc:  # noqa: BLE001 — verbs fail loudly
            try:
                blob = pickle.dumps(exc)
            except Exception:  # noqa: BLE001
                blob = None
            send({"op": "result", "id": req_id, "ok": False,
                  "exc": blob, "error": repr(exc)[:300]})
            mirror(f"verb:{op}:error")
    if shm_stop is not None:
        shm_stop.set()
        for ring in shm_rings:
            ring.close()
    try:
        sock.close()
    except OSError:
        pass


def main() -> None:
    # chaos first: a parent FaultPlan that rode the spawn env must be
    # live before any serving code runs, so even spawn-path sites fire
    from fm_returnprediction_tpu_torch.resilience.faults import (
        install_plan_from_env,
    )
    from fm_returnprediction_tpu_torch.telemetry.distributed import (
        install_remote_context_from_env,
    )

    install_plan_from_env()
    # remote trace context second: every root span this process opens
    # carries the router's spawning span as remote_trace/remote_parent
    install_remote_context_from_env()
    with open(sys.argv[1], "rb") as fh:
        cfg = pickle.load(fh)
    _serve(cfg)


if __name__ == "__main__":
    main()
