"""More than one process: ``torch.distributed`` bring-up and the
months × firms mesh.

Every process runs the same program; ``initialize_multihost`` joins them
into one ``torch.distributed`` group, and a mesh may then span the devices
of every process, each process holding the shards of its own positions.
The hierarchy lays the axes out so each collective stays where it is
cheap:

- **months → processes.** The per-month regressions need no communication
  across months, so the month axis crosses processes and carries one small
  gather per FM run, ``T·(P+1)`` values;
- **firms → the devices of one process.** The firm-axis TSQR gather and
  the statistics sums (``parallel.fm_sharded``) stay inside a process.

The bootstrap needs one ``psum`` of 2·P values, so it flattens the same
devices into one replicate axis (``as_flat_mesh``).

Backend: ``nccl`` when every rank owns a card of its own (the rank is then
pinned to ``cuda:<rank % cards>``), ``gloo`` otherwise — two ranks on one
card cannot form an NCCL group, so there (and on the CPU) the collectives'
payloads go through the host. A group that fails to come up raises: there
is no fallback to one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch

from fm_returnprediction_tpu_torch.ops.fama_macbeth import (
    FamaMacbethSummary,
    fama_macbeth_summary,
)
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult
from fm_returnprediction_tpu_torch.parallel.fm_sharded import cs_ols_kernel
from fm_returnprediction_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    Placed,
    all_gather,
    local_devices,
    pad_to_multiple,
    place_global,
)

__all__ = [
    "as_flat_mesh",
    "distributed_client_active",
    "fama_macbeth_hier",
    "initialize_multihost",
    "make_mesh_2d",
    "pinned_card",
    "process_count",
    "process_index",
]

# the card this rank of an NCCL group is pinned to (None elsewhere)
_PINNED: Optional[int] = None
# how long a rank waits for the others to join the group
_INIT_TIMEOUT_S = 300.0


def distributed_client_active() -> bool:
    """True when this process has joined a ``torch.distributed`` group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    return torch.distributed.get_rank() if distributed_client_active() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if distributed_client_active() else 1


def pinned_card() -> Optional[int]:
    """The card an NCCL rank is pinned to, or None."""
    return _PINNED


def _backend(num_processes: int) -> str:
    if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> tuple:
    """Join the ``torch.distributed`` group of a run across processes, or
    do nothing. Returns ``(process_index, process_count)``.

    In order: explicit arguments; else ``FMRP_MULTIHOST=1``, which reads the
    ``FMRP_DIST_*`` configuration (``parallel.distributed.DistConfig``) and
    puts the group's store on the coordinator's port + 1 (the host
    exchange holds the port itself); else ``(0, 1)`` without touching
    ``torch.distributed``. Idempotent. The backend is ``nccl`` when every
    rank can own a card, else ``gloo`` (module docstring)."""
    global _PINNED
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and os.environ.get("FMRP_MULTIHOST", "0") != "1":
        return 0, 1
    if distributed_client_active():
        return process_index(), process_count()
    if not explicit:
        from fm_returnprediction_tpu_torch.parallel.distributed import DistConfig

        cfg = DistConfig.from_env()
        if cfg is None:
            raise ValueError("FMRP_MULTIHOST=1 needs FMRP_DIST_COORDINATOR, FMRP_DIST_PROCS "
                             "and FMRP_DIST_PROC_ID")
        coordinator_address = f"{cfg.host}:{cfg.port + 1}"
        num_processes, process_id = cfg.num_processes, cfg.process_id
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs coordinator_address, num_processes "
                         "and process_id together")
    backend = _backend(int(num_processes))
    if backend == "nccl":
        _PINNED = int(process_id) % torch.cuda.device_count()
        torch.cuda.set_device(_PINNED)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S))
    return process_index(), process_count()


def make_mesh_2d(
    month_shards: Optional[int] = None,
    month_axis: str = "months",
    firm_axis: str = "firms",
    devices: Optional[Sequence[torch.device]] = None,
    device=None,
) -> Mesh:
    """The (month_shards, devices // month_shards) mesh. Without
    ``devices`` it holds every process's ``local_devices(device)``
    ordered by (process, local id), and ``month_shards`` defaults to the
    process count, so each mesh row is one process's devices. A device
    count that does not factor raises."""
    if devices is not None:
        flat = list(devices)
        owners = [0] * len(flat)
    else:
        mine = [str(d) for d in local_devices(device)]
        if process_count() > 1:
            everyone = [None] * process_count()
            torch.distributed.all_gather_object(everyone, mine)
        else:
            everyone = [mine]
        flat = [torch.device(d) for names in everyone for d in names]
        owners = [rank for rank, names in enumerate(everyone) for _ in names]
    h = process_count() if month_shards is None else month_shards
    if h < 1:
        raise ValueError(f"month_shards must be >= 1, got {h}")
    d, rem = divmod(len(flat), h)
    if rem or d == 0:
        raise ValueError(f"{len(flat)} devices do not factor into {h} month shards")
    return Mesh(np.asarray(flat, dtype=object).reshape(h, d), (month_axis, firm_axis),
                np.asarray(owners).reshape(h, d))


def as_flat_mesh(mesh: Mesh, axis_name: str = "boot") -> Mesh:
    """The same devices as a 1-D mesh (the bootstrap's replicate axis)."""
    return mesh.reshape((-1,), (axis_name,))


def _gather_month_shards(mesh: Mesh, parts: list, month_axis: str) -> list:
    """Full (T, ...) results from contiguous month shards: one
    ``all_gather`` over the month axis, the shards concatenated in month
    order."""
    gathered = all_gather(mesh, parts, month_axis)
    return [type(g)(*(leaf.reshape((-1,) + tuple(leaf.shape[2:])) for leaf in g))
            for g in gathered]


def fama_macbeth_hier(
    y,
    x,
    mask,
    mesh: Optional[Mesh] = None,
    month_axis: str = "months",
    firm_axis: str = "firms",
    nw_lags: int = 4,
    min_months: int = 10,
    weight: str = "reference",
    n_refine: int = 2,
    place: bool = True,
) -> tuple:
    """Fama-MacBeth on a 2-D months × firms mesh: the months pad to a
    multiple of the month axis (NaN/False rows, which fail the ``n >= P+1``
    gate like a skipped month and are trimmed from the per-month result),
    the firms to a multiple of the firm axis; each month row solves its
    months with the firm-sharded ``cs_ols_kernel``, one gather over the
    month axis rebuilds the series, and the FM summary follows. ``y``,
    ``x``, ``mask`` are the whole arrays in every process (numpy or
    tensors); with ``place=False`` they are already padded and placed
    (``place_global`` over ``P(month_axis, firm_axis[, None])``) and go to
    the kernel as they are. Returns ``(cs, summary)`` on this process's
    first mesh device. ``mesh=None`` builds ``make_mesh_2d`` over the local
    devices of ``y``'s kind."""
    if mesh is None:
        kind = (y.shards[0] if isinstance(y, Placed) else y)
        kind = kind.device.type if isinstance(kind, torch.Tensor) else None
        mesh = make_mesh_2d(month_axis=month_axis, firm_axis=firm_axis, device=kind)
    t = y.shape[0]
    h = mesh.shape[month_axis]
    d = mesh.shape[firm_axis]
    if place:
        y = pad_to_multiple(pad_to_multiple(y, 0, h, float("nan")), 1, d, float("nan"))
        x = pad_to_multiple(pad_to_multiple(x, 0, h, float("nan")), 1, d, float("nan"))
        mask = pad_to_multiple(pad_to_multiple(mask, 0, h, False), 1, d, False)
        s2 = NamedSharding(mesh, P(month_axis, firm_axis))
        s3 = NamedSharding(mesh, P(month_axis, firm_axis, None))
        yp, xp, mp = place_global(y, s2), place_global(x, s3), place_global(mask, s2)
    else:
        yp, xp, mp = y, x, mask
    local = cs_ols_kernel(mesh, yp.shards, xp.shards, mp.shards, firm_axis, d,
                          min(n_refine, 1))
    cs = _gather_month_shards(mesh, local, month_axis)[0]
    summary = fama_macbeth_summary(cs, nw_lags=nw_lags, min_months=min_months, weight=weight)
    return CSRegressionResult(*(leaf[:t] for leaf in cs)), FamaMacbethSummary(*summary)
