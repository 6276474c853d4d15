"""The spec grid across processes: a firm-sharded contraction over a pool of
worker processes.

Each contraction worker is a spawned Python process (``python -m
fm_returnprediction_tpu_torch.specgrid.mp_worker``, never a fork) holding
one contiguous firm shard of the panel on its device, and launching the
Gram kernel (K2, ``grams.contract_spec_grams``) once per grid call on that
shard. The merge rides the host exchange
(``parallel.distributed.HostExchange``). The algebra is exact because the
Gram stats are additive over firms given a fixed center; two exchange
rounds per pool:

1. the center round (the pool's first grid only, then cached on both
   sides): ``sum_tree`` of the per-shard masked column sums and counts,
   so every rank derives the same global per-month center;
2. per grid call, a gather of the per-shard stats to the parent, which
   sums them in rank order.

The parent then runs the single-process solve (``solve._solve_and_
aggregate`` and the QR referee) on the merged stats, so the route returns
the single-process result structure. It is held against the reference's
single-process grid (rtol 1e-13 f64, 1e-6 f32,
``tests/test_torch_multiprocess.py``); merged stats are not bit-equal to
one process's (another summation order).

Topology: world = ``procs`` workers (ranks 1..procs, equal shard widths,
firms padded with inert NaN/False slots) + the parent as rank 0, which
contributes nothing to the sums.

Data plane (``FMRP_GRID_TRANSPORT`` / ``transport=``): ``frames`` writes
the panel once as ``.npy`` files that workers map and cut their shard
from, and returns stats in pickled exchange frames; ``shm`` publishes the
panel into named shared-memory segments and workers write their stats
into per-worker response segments the parent sums in place, so the
exchange carries control frames only. Both fold in the same rank order
and agree bit for bit. ``auto`` is ``shm`` only where the panel's
segments fit ``/dev/shm`` (``parallel.shm.shm_available(nbytes)``).

Kernels in the workers. The first contraction after a (re)spawn on the
card is staggered: worker 1 makes the Gram library loadable
(``cuda_build.build_kernels(["gram"])``: reuse, registry fetch, or one
``nvcc`` build, stored for the next process), a barrier releases the rest,
and they find it in the shared build directory or the registry, so the
pool runs at most one ``nvcc`` build. Every worker reports, in each
round's reply, its device, its K2 launches and its builds
(``pool.last_reports``); the pool sums the launches into
:data:`WORKER_LAUNCHES`, because the parent's own counter reads 0 on this
path.

Workers persist across grid calls (the tile engine calls
``run_spec_grid_weights`` once per spec batch), cached one pool at a time
keyed by (procs, transport, device, panel identity), and reaped at exit.
If a worker dies mid-round, the pool respawns the surviving shards as a
smaller world and re-runs the round, disclosed in ``degraded_ranks``;
``FMRP_TOPO_DEGRADED_GRID=0`` raises ``DegradedWorldError`` instead.

Knob: ``FMRP_SPECGRID_PROCS`` (unset/``0``/``1`` = one process; ``N`` = N
workers) or ``run_spec_grid_weights(procs=)``. Not with bf16 operands or
the factorized route (``solve.run_spec_grid_weights`` raises).
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "GRID_TRANSPORTS",
    "SpecGridWorkerPool",
    "WORKER_LAUNCHES",
    "multiproc_grid_stats",
    "resolve_grid_transport",
    "resolve_specgrid_procs",
    "worker_main",
]

GRID_TRANSPORTS = ("shm", "frames")

#: K2 launches made in worker processes, by the wrapper's launch key
#: (``grams.gram_contract_cuda.launches_by_key``), summed from the reports
WORKER_LAUNCHES: collections.Counter = collections.Counter()

_REPO_ROOT = str(Path(__file__).resolve().parents[2])


def resolve_grid_transport(transport: Optional[str] = None, nbytes: int = 0) -> str:
    """The pool's data plane: explicit argument > ``FMRP_GRID_TRANSPORT``
    > ``auto`` (= ``shm`` where POSIX shared memory works and ``nbytes``
    fit ``/dev/shm``, else ``frames``)."""
    if transport is None:
        transport = os.environ.get("FMRP_GRID_TRANSPORT", "").strip().lower() or "auto"
    if transport in GRID_TRANSPORTS:
        return transport
    if transport != "auto":
        raise ValueError(
            f"grid transport must be one of {('auto',) + GRID_TRANSPORTS}, got {transport!r}")
    from fm_returnprediction_tpu_torch.parallel.shm import shm_available

    return "shm" if shm_available(nbytes) else "frames"


def resolve_specgrid_procs(procs: Optional[int] = None) -> int:
    """The multi-process policy: explicit argument, then
    ``FMRP_SPECGRID_PROCS`` (unset/``0``/``1`` → 1, one process)."""
    if procs is not None:
        return max(int(procs), 1)
    want = os.environ.get("FMRP_SPECGRID_PROCS", "").strip().lower()
    if want in ("", "0", "1"):
        return 1
    return max(int(want), 1)


def _stats_leaf_shapes(s_specs: int, t: int, q: int):
    """The five additive stats leaves a worker returns, in wire order:
    gram, moment, n, Σy, Σy²."""
    return ((s_specs, t, q, q), (s_specs, t, q), (s_specs, t), (s_specs, t), (s_specs, t))


def _stats_leaf_views(flat, shapes):
    """Slice a flat segment view into the per-leaf views: the one home of
    the wire layout, for the worker's write and the parent's read."""
    views = []
    off = 0
    for s in shapes:
        size = int(np.prod(s))
        views.append(flat[off:off + size].reshape(s))
        off += size
    return views


# -- the worker side ---------------------------------------------------------


class _WorkerState:
    """One worker process's firm shard, on its device."""

    def __init__(self, paneldir: Path, rank: int, procs: int, device: str):
        import torch

        meta = json.loads((paneldir / "meta.json").read_text())
        self.t = int(meta["t"])
        self.p = int(meta["p"])
        self.transport = meta.get("transport", "frames")
        n_pad = int(meta["n_pad"])
        n_local = n_pad // procs
        k = rank - 1  # contraction ranks are 1..procs
        sl = slice(k * n_local, (k + 1) * n_local)
        if self.transport == "shm":
            from fm_returnprediction_tpu_torch.parallel.shm import ShmArraySpec, attach_array

            def shard(key, slicer):
                spec_meta = meta["panel"].get(key)
                if spec_meta is None:
                    return None
                seg, view = attach_array(ShmArraySpec.from_meta(spec_meta))
                out = np.ascontiguousarray(view[slicer])
                del view
                seg.close()
                return out
        else:
            def shard(key, slicer):
                path = paneldir / f"{key}.npy"
                if not path.exists():
                    return None
                return np.ascontiguousarray(np.load(path, mmap_mode="r")[slicer])

        host = {
            "y": shard("y", np.s_[:, sl]),
            "x": shard("x", np.s_[:, sl, :]),
            "universes": shard("universes", np.s_[:, :, sl]),
            "row_weights": shard("row_weights", np.s_[:, sl]),
        }
        self.device = torch.device(device)
        dev = {k: (None if v is None else torch.from_numpy(v).to(self.device))
               for k, v in host.items()}
        self.y, self.x = dev["y"], dev["x"]
        self.universes, self.row_weights = dev["universes"], dev["row_weights"]
        self.n_local = n_local
        self.dtype = host["x"].dtype
        self._stats_segs: Dict[str, tuple] = {}  # name → (seg, views)
        self._center: Optional[np.ndarray] = None
        # per-shard center partials are job-independent: computed once
        fin = torch.isfinite(self.x)
        self.center_sum = torch.where(fin, self.x, torch.zeros_like(self.x)).sum(
            dim=1).cpu().numpy()
        self.center_count = fin.sum(dim=1).to(torch.int64).cpu().numpy()
        self.launches = 0
        self.launches_by_key: Dict[str, int] = {}

    def ensure_kernels(self) -> None:
        """Make the Gram library loadable on the card (reuse, registry
        fetch or build); nothing to do on the CPU."""
        if self.device.type == "cuda":
            from fm_returnprediction_tpu_torch import cuda_build

            cuda_build.build_kernels(["gram"])

    def contract(self, job: dict, center: np.ndarray):
        import torch

        from fm_returnprediction_tpu_torch.specgrid.grams import (
            contract_spec_grams,
            gram_contract_cuda,
        )

        as_dev = lambda a: torch.as_tensor(np.asarray(a), device=self.device)  # noqa: E731
        before = dict(gram_contract_cuda.launches_by_key)
        n0 = gram_contract_cuda.launches
        stats = contract_spec_grams(
            self.y, self.x, self.universes, as_dev(job["uidx"]).long(),
            as_dev(job["col_sel"]).bool(), as_dev(job["window"]).bool(),
            firm_chunk=job.get("firm_chunk"), center=as_dev(center),
            row_weights=self.row_weights, expect_shared_center=True)
        out = tuple(leaf.cpu().numpy() for leaf in stats[:5])
        self.launches = gram_contract_cuda.launches - n0
        self.launches_by_key = {
            k: v - before.get(k, 0) for k, v in gram_contract_cuda.launches_by_key.items()
            if v != before.get(k, 0)}
        return out

    def write_stats(self, name: str, shapes, stats) -> int:
        """Write the five additive leaves into this worker's mapped
        response segment (the parent sums them in place). Attachments are
        cached by name: the parent reuses one segment per (worker, S)."""
        from fm_returnprediction_tpu_torch.parallel.shm import ShmArraySpec, attach_array

        cached = self._stats_segs.get(name)
        if cached is None:
            n_items = sum(int(np.prod(s)) for s in shapes)
            seg, flat = attach_array(ShmArraySpec(name, (n_items,), str(self.dtype)))
            cached = (seg, _stats_leaf_views(flat, shapes))
            self._stats_segs[name] = cached
        _, views = cached
        total = 0
        for view, leaf in zip(views, stats):
            view[...] = leaf
            total += leaf.nbytes
        return total

    def report(self, rank: int, shard_rank: int) -> dict:
        """This worker's evidence for one round: device, launches, builds."""
        from fm_returnprediction_tpu_torch import cuda_build

        return {
            "rank": shard_rank, "exchange_rank": rank, "pid": os.getpid(),
            "device": str(self.device), "launches": int(self.launches),
            "launches_by_key": dict(self.launches_by_key),
            "nvcc_runs": int(cuda_build.NVCC_RUNS),
            "fetched": len(cuda_build._FETCHED),
        }


def worker_main(paneldir: str) -> None:
    """The spawned contraction worker: join the exchange, load the firm
    shard onto ``FMRP_GRID_DEVICE``, answer contract jobs until the parent
    broadcasts stop."""
    from fm_returnprediction_tpu_torch.parallel import distributed as dist
    from fm_returnprediction_tpu_torch.parallel.shm import transport_instruments
    from fm_returnprediction_tpu_torch.resilience.faults import fault_site

    rank, world = dist.initialize_distributed()
    ex = dist.host_exchange()
    if ex is None or rank < 1:
        raise dist.DistributedError("grid worker ranks start at 1")
    # shard identity is decoupled from exchange rank: a degraded respawn
    # renumbers the exchange ranks 1..S, but each survivor keeps cutting
    # its original firm slice
    shard_rank = int(os.environ.get("FMRP_GRID_SHARD_RANK", rank))
    shard_procs = int(os.environ.get("FMRP_GRID_SHARD_PROCS", world - 1))
    device = os.environ.get("FMRP_GRID_DEVICE", "cuda")
    state = _WorkerState(Path(paneldir), shard_rank, shard_procs, device)
    inst = transport_instruments(f"grid_{state.transport}", f"rank{rank}")

    def handle(job: dict) -> None:
        # a worker dying with the job received and the merge unposted
        fault_site("grid.rank_death")
        # a respawned survivor receives the pool's cached center in the
        # job, so its partial sums stay exact w.r.t. the original center
        if job.get("center") is not None:
            state._center = np.asarray(job["center"], dtype=state.dtype)
        # strictly follow the job flag: a one-sided round deadlocks
        if job.get("center_round"):
            s, c = ex.sum_tree((state.center_sum, state.center_count))
            state._center = (s / np.maximum(c, 1)).astype(state.dtype)
        if job.get("stagger"):
            # worker 1 builds (or fetches) the library first; the rest
            # find it in the shared build directory or the registry
            if rank == 1:
                state.ensure_kernels()
            ex.barrier("mp_warm")
            if rank != 1:
                state.ensure_kernels()
        stats = state.contract(job, state._center)
        report = state.report(rank, shard_rank)
        stats_shm = job.get("stats_shm")
        if stats_shm is not None:
            wrote = state.write_stats(stats_shm["names"][rank - 1],
                                      [tuple(s) for s in stats_shm["shapes"]], stats)
            inst["bytes_out"].inc(wrote)
            inst["frames"].inc()
            ex.gather_obj(("ok", report), root=0)
        else:
            # a gather, not an allgather: only rank 0 solves
            ex.gather_obj((stats, report), root=0)

    dist.run_rounds(handle)
    print(f"MPGRID_DONE {rank}", flush=True)


# -- the parent-side pool ----------------------------------------------------


class SpecGridWorkerPool:
    """``procs`` persistent contraction workers + the parent as rank 0.

    The parent writes the panel once (``.npy`` files or shared-memory
    segments, firms padded to a worker multiple with inert NaN/False
    slots), spawns the workers on ``device`` (``"cuda"`` unless the caller
    asks for ``"cpu"``), and drives any number of grid contractions
    through the exchange. ``close()`` (or interpreter exit) stops the
    workers and removes the scratch tree and segments.
    """

    def __init__(self, procs: int, y, x, universes, row_weights=None,
                 child_env: Optional[dict] = None, cpus_per_worker: Optional[int] = None,
                 transport: Optional[str] = None, device: str = "cuda"):
        if procs < 1:
            raise ValueError("procs must be >= 1")
        self.procs = int(procs)
        self.device = str(device)
        if cpus_per_worker is None:
            env_cpw = os.environ.get("FMRP_SPECGRID_CPUS_PER_PROC", "")
            cpus_per_worker = int(env_cpw) if env_cpw.strip() else None
        if cpus_per_worker:
            # clamp so the last worker's slice exists on this host
            ncpu = os.cpu_count() or 1
            cpus_per_worker = max(1, min(int(cpus_per_worker), ncpu // self.procs))
        self.cpus_per_worker = cpus_per_worker
        self.spawn_timeout_s = float(os.environ.get("FMRP_DIST_TIMEOUT_S", "120"))
        y = np.asarray(y)
        x = np.asarray(x)
        universes = np.asarray(universes)
        t, n, p = x.shape
        self.t, self.n, self.p = t, n, p
        self.dtype = x.dtype
        pad = (-n) % self.procs
        if pad:
            y = np.concatenate([y, np.full((t, pad), np.nan, y.dtype)], axis=1)
            x = np.concatenate([x, np.full((t, pad, p), np.nan, x.dtype)], axis=1)
            universes = np.concatenate(
                [universes, np.zeros(universes.shape[:2] + (pad,), universes.dtype)], axis=2)
            if row_weights is not None:
                row_weights = np.asarray(row_weights)
                row_weights = np.concatenate(
                    [row_weights, np.zeros((t, pad), row_weights.dtype)], axis=1)
        panel = {"y": y, "x": x, "universes": universes, "row_weights": row_weights}
        panel_bytes = sum(int(a.nbytes) for a in panel.values() if a is not None)
        self.transport = resolve_grid_transport(transport, nbytes=panel_bytes)
        self.paneldir = Path(tempfile.mkdtemp(prefix="fmrp_mpgrid_"))
        self._panel_segs: List = []   # published panel segments (owner)
        self._stats_segs: Dict = {}   # S → per-worker segments
        self._center: Optional[np.ndarray] = None
        self.workers: List[subprocess.Popen] = []
        self._closed = False
        self._lock = threading.Lock()
        self.exchange = None
        try:
            meta = {"t": t, "p": p, "n_pad": int(y.shape[1]), "procs": self.procs,
                    "transport": self.transport}
            if self.transport == "shm":
                from fm_returnprediction_tpu_torch.parallel.shm import publish_array

                panel_meta = {}
                for key, arr in panel.items():
                    if arr is None:
                        continue
                    seg, spec = publish_array(arr)
                    self._panel_segs.append(seg)
                    panel_meta[key] = spec.to_meta()
                meta["panel"] = panel_meta
            else:
                for key, arr in panel.items():
                    if arr is not None:
                        np.save(self.paneldir / f"{key}.npy", arr)
            (self.paneldir / "meta.json").write_text(json.dumps(meta))
            self._child_env = dict(child_env or {})
            # shard assignment per live worker, in worker order: the full
            # world is [1..procs]; a degraded respawn keeps the survivors'
            # original shard ranks while exchange ranks renumber
            self._shard_ranks: List[int] = list(range(1, self.procs + 1))
            self.degraded_ranks: tuple = ()
            self._allow_degraded = os.environ.get(
                "FMRP_TOPO_DEGRADED_GRID", "1").strip().lower() not in ("0", "false", "no")
            self._need_center_ship = False
            self._registry_armed = bool(self._child_env.get("FMRP_REGISTRY_DIR")
                                        or os.environ.get("FMRP_REGISTRY_DIR"))
            self.last_reports: List[dict] = []
            self.worker_launches = 0
            self.last_merge_s = 0.0
            self.last_merge_bytes = 0
            self.last_shm_bytes = 0
            self._start_world(self._shard_ranks)
        except BaseException:
            self.close()
            raise
        from fm_returnprediction_tpu_torch.parallel.shm import transport_instruments

        self._inst = transport_instruments(f"grid_{self.transport}", "pool")
        # the parent's zero partials (exact identities under the merge)
        self._zero_center = (np.zeros((t, p), self.dtype), np.zeros((t, p), np.int64))

    def _spawn_worker(self, rank: int, world: int, port: int,
                      shard_rank: int) -> subprocess.Popen:
        """Spawn one worker with exchange rank ``rank`` in a world of
        ``world`` and the (possibly different) panel shard ``shard_rank``:
        a fresh interpreter, never a fork of a process that holds CUDA."""
        from fm_returnprediction_tpu_torch.parallel.distributed import worker_env

        env = worker_env(rank, world, port)
        # the repo goes after what the caller put on the path
        env["PYTHONPATH"] = (env["PYTHONPATH"] + os.pathsep + _REPO_ROOT
                             if env.get("PYTHONPATH") else _REPO_ROOT)
        env["FMRP_GRID_SHARD_RANK"] = str(shard_rank)
        env["FMRP_GRID_SHARD_PROCS"] = str(self.procs)
        env["FMRP_GRID_DEVICE"] = self.device
        env.setdefault("FMRP_DIST_TIMEOUT_S", str(self.spawn_timeout_s))
        if self.cpus_per_worker:
            c = int(self.cpus_per_worker)
            ncpu = os.cpu_count() or 1
            lo = ((shard_rank - 1) * c) % ncpu
            hi = min(lo + c - 1, ncpu - 1)
            env["FMRP_PROC_CPUS"] = f"{lo}-{hi}"
        env.update(self._child_env)
        log = open(self.paneldir / f"worker{shard_rank}.log", "wb")
        try:
            return subprocess.Popen(
                [sys.executable, "-m", "fm_returnprediction_tpu_torch.specgrid.mp_worker",
                 str(self.paneldir)],
                env=env, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    def _worker_log(self, shard_rank: int, n: int = 2000) -> str:
        try:
            data = (self.paneldir / f"worker{shard_rank}.log").read_bytes()
        except OSError:
            return "<no log>"
        return data[-n:].decode(errors="replace")

    def _dead_worker(self) -> Optional[str]:
        """Why the world cannot form: a worker that exited before joining."""
        for shard, w in zip(self._shard_ranks, self.workers):
            if w.poll() is not None:
                return (f"grid worker {shard} exited with {w.returncode} before the "
                        f"exchange formed; log: {self._worker_log(shard)}")
        return None

    def _start_world(self, shards: List[int]) -> None:
        """Spawn ``shards`` and join them behind a fresh exchange; a worker
        that dies before joining fails the call at once."""
        from fm_returnprediction_tpu_torch.parallel.distributed import (
            DistConfig,
            HostExchange,
            free_port,
        )

        port = free_port()
        world = len(shards) + 1
        self._shard_ranks = list(shards)
        self.workers = [self._spawn_worker(i, world, port, shard)
                        for i, shard in enumerate(shards, start=1)]
        self.exchange = HostExchange(
            DistConfig(coordinator=f"127.0.0.1:{port}", num_processes=world, process_id=0),
            timeout_s=self.spawn_timeout_s, watch=self._dead_worker)
        # the first contraction of a fresh world staggers the kernel build
        self._warm = False

    # -- one grid contraction ---------------------------------------------

    def contract(self, uidx, col_sel, window, firm_chunk=None, report: bool = False):
        """One firm-sharded contraction across the pool: the merged stats
        ``(gram, moment, n, ysum, yy, center)`` as numpy arrays. With
        ``report`` each worker's report of the round (rank, device, pid,
        launches, nvcc runs, registry fetches) lands in ``last_reports``;
        the pool counts the workers' launches either way. A worker that
        dies mid-round degrades the world (``degraded_ranks``) or, with
        ``FMRP_TOPO_DEGRADED_GRID=0``, raises ``DegradedWorldError``; a
        broker death re-elects once (the full world respawned)."""
        from fm_returnprediction_tpu_torch.parallel.distributed import DistributedError

        uidx = np.asarray(uidx)
        col_sel = np.asarray(col_sel)
        window = np.asarray(window)
        with self._lock:
            if self._closed:
                raise RuntimeError("worker pool is closed")
            re_elected = False
            while True:
                try:
                    return self._contract_locked(uidx, col_sel, window, firm_chunk, report)
                except DistributedError as exc:
                    dead = self._reap_dead_ranks()
                    if dead:
                        self._degrade_locked(dead, exc)
                    elif not re_elected:
                        # no corpse shows a signal death: the broker died
                        # mid-round; every shard is intact, so the same
                        # world respawns behind a fresh broker, once
                        re_elected = True
                        self._reelect_locked(exc)
                    else:
                        raise

    def _contract_locked(self, uidx, col_sel, window, firm_chunk, report):
        s_specs = col_sel.shape[0]
        q = self.p + 1
        stagger = not self._warm and (self.device.startswith("cuda") or self._registry_armed)
        self._warm = True
        ex = self.exchange
        center_round = self._center is None
        shapes = _stats_leaf_shapes(s_specs, self.t, q)
        stats_shm = None
        if self.transport == "shm":
            stats_shm = {"names": [seg.name for seg, _ in self._stats_segments(s_specs, shapes)],
                         "shapes": [list(s) for s in shapes]}
        ship_center = self._need_center_ship and self._center is not None
        job = {
            "op": "contract", "uidx": uidx, "col_sel": col_sel, "window": window,
            "firm_chunk": firm_chunk, "stagger": stagger, "center_round": center_round,
            "stats_shm": stats_shm, "center": self._center if ship_center else None,
        }
        t0 = time.perf_counter()
        bytes0 = self._transport_bytes()
        ex.broadcast_obj(job, root=0)
        if ship_center:
            self._need_center_ship = False
        if center_round:
            s, c = ex.sum_tree(self._zero_center)
            self._center = (s / np.maximum(c, 1)).astype(self.dtype)
        if stagger:
            ex.barrier("mp_warm")
        totals = [np.zeros(s, self.dtype) for s in shapes]
        parts = [part for part in ex.gather_obj(None, root=0) if part is not None]
        if stats_shm is not None:
            # the stats live in the mapped segments, summed here in rank
            # order (the frames route's fold, so the two agree bit for bit)
            shm_bytes = 0
            for _seg, views in self._stats_segments(s_specs, shapes):
                for total, view in zip(totals, views):
                    np.add(total, view, out=total)
                    shm_bytes += view.nbytes
            self.last_shm_bytes = shm_bytes
            self._inst["bytes_in"].inc(shm_bytes)
        else:
            for stats, _ in parts:
                for total, leaf in zip(totals, stats):
                    np.add(total, leaf, out=total)
            self.last_shm_bytes = 0
        reports = [worker_report for _, worker_report in parts]
        if report:
            self.last_reports = reports
        for worker_report in reports:
            self.worker_launches += worker_report["launches"]
            WORKER_LAUNCHES.update(worker_report["launches_by_key"])
        self.last_merge_s = time.perf_counter() - t0
        self.last_merge_bytes = self._transport_bytes() - bytes0
        return (*totals, self._center.copy())

    def _reap_dead_ranks(self) -> List[int]:
        """Reap the workers and name the shards that died by signal. Once
        one dies mid-round the broker tears the world down, so the others
        exit too, with a ``DistributedError`` (a positive return code);
        only the instigator shows a signal death."""
        dead: List[int] = []
        for shard, w in zip(self._shard_ranks, self.workers):
            escalated = False
            try:
                w.wait(timeout=10)
            except subprocess.TimeoutExpired:
                # our own escalation is teardown, not a member death
                escalated = True
                w.kill()
                try:
                    w.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            rc = w.returncode
            if rc is not None and rc < 0 and not escalated:
                dead.append(shard)
        return dead

    def _degrade_locked(self, dead: List[int], cause: Exception) -> None:
        """Shrink the world to the surviving shards and respawn: the merged
        stats are then the exact partial sum over the survivors under the
        original center, disclosed in ``degraded_ranks`` and counted in
        ``fmrp_topology_degraded_grid_total``."""
        from fm_returnprediction_tpu_torch import telemetry
        from fm_returnprediction_tpu_torch.resilience.errors import DegradedWorldError

        survivors = [r for r in self._shard_ranks if r not in dead]
        if not survivors or not self._allow_degraded:
            why = ("no shard survives" if not survivors else
                   "FMRP_TOPO_DEGRADED_GRID=0 refuses a partial world")
            raise DegradedWorldError(
                f"grid shard(s) {sorted(dead)} died mid-merge; {why}",
                dead_ranks=sorted(dead)) from cause
        self.degraded_ranks = tuple(sorted(set(self.degraded_ranks) | set(dead)))
        self._respawn_world_locked(survivors)
        telemetry.registry().counter(
            "fmrp_topology_degraded_grid_total",
            help="grid rounds re-run on a disclosed degraded N-1 world").inc()

    def _reelect_locked(self, cause: Exception) -> None:
        """Broker re-election: the same shards respawn behind a fresh
        exchange and the round fans out again."""
        from fm_returnprediction_tpu_torch import telemetry

        self._respawn_world_locked(list(self._shard_ranks))
        telemetry.registry().counter(
            "fmrp_topology_broker_reelections_total",
            help="grid exchange brokers replaced after mid-round death").inc()

    def _respawn_world_locked(self, shards: List[int]) -> None:
        try:
            self.exchange.close()
        except Exception:  # noqa: BLE001 — already torn down
            pass
        # response segments are sized per live worker: release the old set
        self._release_stats_segments()
        # respawned processes are cold: ship the cached center next job
        self._need_center_ship = self._center is not None
        self._start_world(shards)

    def _stats_segments(self, s_specs: int, shapes):
        """Per-worker mapped response segments for this S, created once and
        reused across grid calls, in worker rank order (the merge's fold
        order), sized to the live world."""
        from fm_returnprediction_tpu_torch.parallel.shm import publish_array

        cached = self._stats_segs.get(s_specs)
        if cached is not None:
            return cached
        n_items = sum(int(np.prod(s)) for s in shapes)
        entries = []
        for _ in range(len(self._shard_ranks)):
            seg, _spec = publish_array(np.zeros(n_items, self.dtype))
            flat = np.ndarray((n_items,), dtype=self.dtype, buffer=seg.buf)
            entries.append((seg, _stats_leaf_views(flat, shapes)))
        self._stats_segs[s_specs] = entries
        return entries

    def _release_stats_segments(self) -> None:
        from fm_returnprediction_tpu_torch.parallel.shm import release_segment

        for entries in self._stats_segs.values():
            for seg, views in entries:
                del views
                release_segment(seg)
        self._stats_segs.clear()

    def _transport_bytes(self) -> int:
        return self.exchange._m_bytes_out.value + self.exchange._m_bytes_in.value

    def close(self) -> None:
        from fm_returnprediction_tpu_torch.parallel.shm import release_segment

        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self.exchange is not None:
                try:
                    self.exchange.broadcast_obj({"op": "stop"}, root=0)
                except Exception:  # noqa: BLE001 — workers may already be dead
                    pass
                self.exchange.close()
        for w in self.workers:
            try:
                w.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait(timeout=10)
        # the mapped planes go after the workers exited (their views die
        # with them; the pool owns every name)
        self._release_stats_segments()
        for seg in self._panel_segs:
            release_segment(seg)
        self._panel_segs.clear()
        shutil.rmtree(self.paneldir, ignore_errors=True)

    def __enter__(self) -> "SpecGridWorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# single-slot pool memo: the tile engine calls the route once per spec
# batch with the same panel tensors, and respawning per batch would
# dominate the sweep. Keyed by the caller's array identities and tensor
# versions (a winsor variant is written into the previous one's buffer);
# the entry holds strong references, so the ids stay valid while cached.
_POOL_CACHE: Optional[tuple] = None


def _array_tag(a):
    return None if a is None else (id(a), getattr(a, "_version", None))


def _get_pool(procs: int, y, x, universe_arrays, row_weights,
              device: str) -> SpecGridWorkerPool:
    global _POOL_CACHE
    key = (procs, os.environ.get("FMRP_GRID_TRANSPORT", ""), device,
           _array_tag(y), _array_tag(x), tuple(_array_tag(u) for u in universe_arrays),
           _array_tag(row_weights))
    cached = _POOL_CACHE
    if cached is not None and cached[0] == key:
        return cached[2]
    if cached is not None:
        _POOL_CACHE = None
        cached[2].close()
    host = _host_array
    universes = np.stack([host(u) for u in universe_arrays]).astype(bool)
    pool = SpecGridWorkerPool(procs, host(y), host(x), universes,
                              None if row_weights is None else host(row_weights),
                              device=device)
    _POOL_CACHE = (key, (y, x, universe_arrays, row_weights), pool)
    return pool


def _host_array(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close_cached_pool() -> None:
    global _POOL_CACHE
    if _POOL_CACHE is not None:
        pool = _POOL_CACHE[2]
        _POOL_CACHE = None
        pool.close()


def cached_pool() -> Optional[SpecGridWorkerPool]:
    """The pool the last multi-process grid call ran on, or None."""
    return None if _POOL_CACHE is None else _POOL_CACHE[2]


atexit.register(_close_cached_pool)


def multiproc_grid_stats(y, x, universe_arrays, uidx, col_sel, window, *, procs: int,
                         row_weights=None, firm_chunk=None, device: str = "cuda"):
    """The multi-process contraction of ``solve.run_spec_grid_weights``:
    the merged ``(gram, moment, n, ysum, yy, center)`` numpy stats.
    ``y``/``x``/``universe_arrays``/``row_weights`` are the caller's own
    objects: their identities key the persistent pool, so repeated grids
    over one panel reuse the spawned processes."""
    pool = _get_pool(procs, y, x, tuple(universe_arrays), row_weights, device)
    return pool.contract(np.asarray(uidx), np.asarray(col_sel), np.asarray(window),
                         firm_chunk=firm_chunk, report=True)
