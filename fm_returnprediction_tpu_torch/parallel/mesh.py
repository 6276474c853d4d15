"""Device mesh construction, panel placement and the mesh collectives —
the one place topology lives.

A reference ``jax.sharding.Mesh`` on one host is single-controller: one
program places shards on several devices and XLA runs the collectives. The
counterpart here is one process holding a list of per-shard tensors:

- :class:`Mesh` holds a numpy object array of ``torch.device``\\ s with one
  dimension per named axis (``axis_names``; ``shape`` maps axis → size),
  and which process owns each position (a mesh across processes, see
  ``parallel.multihost``, holds only its own positions' shards);
- :class:`PartitionSpec` (``P``) and :class:`NamedSharding` keep the
  reference's meaning: entry ``i`` of the spec names the mesh axis that
  splits array dimension ``i`` into equal contiguous blocks (None
  replicates that dimension);
- a placed array (:class:`Placed`) is the list of this process's shards,
  each on its position's device, with its sharding and global shape;
  :func:`place_global` builds one from a numpy array or tensor and
  :meth:`Placed.to_global` rebuilds the whole array.

A sharded program is written in stages: a list comprehension runs the local
work over the shards, and a collective call sits between stages —
:func:`psum`, :func:`all_gather`, :func:`ppermute` and :func:`axis_index`.
Every collective is deterministic: a sum adds the shards in their order
along the axis (on the first member's device, then copied to every member),
with no atomics and no order that depends on timing, so a result never
depends on which shard finished first. Each call adds one to
``COLLECTIVES[(kind, axis)]``; the tests read that counter where the
reference's tests inspect the compiled program. Across processes (a group
of an axis that spans ranks) the members' values travel by
``torch.distributed.all_gather`` first and are then summed in the same
order on every rank, so every rank gets the same bits.

Virtual devices: ``FMRP_VIRTUAL_DEVICES`` (read only by
:func:`local_devices`) is the number of mesh positions each physical device
stands for, the counterpart of the reference tests'
``--xla_force_host_platform_device_count``. Unset means the physical
devices. It lets the sharded programs run with several shards on one card or
on the CPU; it is a test and driver setting, not a speedup: shards of one
card run one after the other on it.

Axis conventions, as in the reference: ``"firms"`` (the N axis of the
dense panel; the cross-sectional stage psums per-month statistics over it),
``"boot"`` (bootstrap replicates), ``"months"`` (the month axis of the
months × firms hierarchy), ``"time"`` (the time-sharded rolling family)
and ``"cells"`` (the spec grid).
"""

from __future__ import annotations

import collections
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device

__all__ = [
    "COLLECTIVES",
    "Mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "Placed",
    "all_gather",
    "axis_index",
    "collective_counts",
    "default_mesh",
    "host_local_mesh",
    "local_devices",
    "make_mesh",
    "mesh_devices_setting",
    "pad_to_multiple",
    "pipeline_mesh",
    "place_global",
    "ppermute",
    "psum",
    "shard_panel",
]

#: collective calls by ``(kind, axis)``: "psum", "all_gather", "ppermute"
COLLECTIVES: collections.Counter = collections.Counter()


def collective_counts() -> Dict[Tuple[str, str], int]:
    """Snapshot of ``COLLECTIVES``."""
    return dict(COLLECTIVES)


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (None replicates the dimension); the
    reference's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """Devices laid out along named axes. ``devices`` is an object array of
    ``torch.device`` with one dimension per axis; ``processes`` (same shape,
    default all 0) is the rank that owns each position."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} dimensions needs as many axis "
                             f"names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.processes = (np.zeros(devices.shape, dtype=np.int64) if processes is None
                          else np.asarray(processes, dtype=np.int64).reshape(devices.shape))

    @property
    def shape(self) -> Dict[str, int]:
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape,
                self.axis_names, tuple(self.processes.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"

    def reshape(self, shape, axis_names: Sequence[str]) -> "Mesh":
        """The same positions in the same order under other axes."""
        return Mesh(self.devices.reshape(shape), axis_names, self.processes.reshape(shape))

    # -- positions ----------------------------------------------------------

    def local_positions(self) -> List[int]:
        """Flat (row-major) positions this process owns."""
        rank = _rank()
        return [i for i, p in enumerate(self.processes.flat) if p == rank]

    def coords(self, pos: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(pos, self.devices.shape))

    def device_of(self, pos: int) -> torch.device:
        return self.devices.flat[pos]

    def local_devices(self) -> List[torch.device]:
        return [self.device_of(p) for p in self.local_positions()]

    def axis_groups(self, axis: str) -> List[List[int]]:
        """The flat positions of each group along ``axis`` (positions that
        differ only in that coordinate), each in axis order."""
        k = self.axis_names.index(axis)
        idx = np.arange(self.size).reshape(self.devices.shape)
        moved = np.moveaxis(idx, k, -1).reshape(-1, self.devices.shape[k])
        return [list(map(int, row)) for row in moved]

    def spans_processes(self, axis: str) -> bool:
        return any(len({int(self.processes.flat[p]) for p in g}) > 1
                   for g in self.axis_groups(axis))


class NamedSharding:
    """A ``PartitionSpec`` on a ``Mesh``."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        for name in spec:
            if name is not None and name not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {name!r}, not one of "
                                 f"{mesh.axis_names}")
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"

    def block(self, pos: int, shape: Sequence[int]) -> Tuple[slice, ...]:
        """Position ``pos``'s index into an array of global ``shape``."""
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords(pos)))
        sizes = self.mesh.shape
        index = []
        for dim, size in enumerate(shape):
            name = self.spec[dim] if dim < len(self.spec) else None
            if name is None:
                index.append(slice(None))
                continue
            parts = sizes[name]
            if size % parts:
                raise ValueError(f"dimension {dim} of size {size} does not split into "
                                 f"{parts} '{name}' shards (pad it first)")
            step = size // parts
            index.append(slice(coords[name] * step, (coords[name] + 1) * step))
        return tuple(index)


class Placed:
    """This process's shards of one array: ``shards[i]`` is the block of
    local position ``positions[i]``, on that position's device."""

    def __init__(self, shards: List[torch.Tensor], sharding: NamedSharding,
                 shape: Sequence[int]):
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.positions = sharding.mesh.local_positions()

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def to_global(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default the first shard's), from
        this process's shards (a mesh across processes holds only its own
        blocks: raises there)."""
        mesh = self.sharding.mesh
        if len(self.positions) != mesh.size:
            raise ValueError("to_global needs every block in this process; a mesh across "
                             "processes holds only its own")
        device = self.shards[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for pos, shard in zip(self.positions, self.shards):
            out[self.sharding.block(pos, self.shape)] = shard.to(device)
        return out

    def numpy(self) -> np.ndarray:
        return self.to_global("cpu").numpy()


# -- devices and meshes -------------------------------------------------------


def _rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _virtual_count() -> int:
    raw = os.environ.get("FMRP_VIRTUAL_DEVICES", "").strip()
    if not raw:
        return 1
    k = int(raw)
    if k < 1:
        raise ValueError(f"FMRP_VIRTUAL_DEVICES must be >= 1, got {raw!r}")
    return k


def local_devices(kind=None) -> List[torch.device]:
    """This process's mesh devices of ``kind`` ("cuda" or "cpu"; None →
    ``cuda``, raising without one): every card (the card a rank of an NCCL
    group is pinned to, ``parallel.multihost``) or the CPU, each repeated
    ``FMRP_VIRTUAL_DEVICES`` times (default once)."""
    dev = resolve_device(kind)
    k = _virtual_count()
    if dev.type == "cpu":
        physical = [torch.device("cpu")]
    else:
        from fm_returnprediction_tpu_torch.parallel import multihost

        pinned = multihost.pinned_card()
        physical = ([torch.device("cuda", pinned)] if pinned is not None else
                    [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return [d for d in physical for _ in range(k)]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "firms",
              devices: Optional[Sequence[torch.device]] = None, device=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` of ``devices`` (default every entry of
    ``local_devices(device)``). Asking for more devices than there are
    raises: "exactly N" is the contract, never a silent cap."""
    if devices is None:
        devices = local_devices(device)
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"Requested {n_devices} devices but only {len(devices)} available")
    return Mesh(np.asarray(devices[:n_devices], dtype=object), (axis_name,))


def host_local_mesh(axis_name: str = "firms", device=None) -> Mesh:
    """Every device of this process as a 1-D mesh."""
    return make_mesh(axis_name=axis_name, device=device)


def pad_to_multiple(arr, axis: int, multiple: int, fill=0.0):
    """Pad ``arr`` (tensor or numpy) along ``axis`` up to the next multiple
    of ``multiple`` with ``fill``. Firm pads carry NaN values and False
    masks, so every masked computation drops them."""
    size = arr.shape[axis]
    target = math.ceil(size / multiple) * multiple
    if target == size:
        return arr
    if isinstance(arr, np.ndarray):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, target - size)
        return np.pad(arr, widths, constant_values=fill)
    pad_shape = list(arr.shape)
    pad_shape[axis] = target - size
    pad = torch.full(pad_shape, fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=axis)


def place_global(a, sharding: NamedSharding) -> Placed:
    """Split ``a`` (numpy array or tensor) by ``sharding`` into this
    process's shards, each contiguous on its position's device (a block
    already on its device and contiguous is a view, not a copy)."""
    shape = tuple(a.shape)
    mesh = sharding.mesh
    shards = []
    for pos in mesh.local_positions():
        block = a[sharding.block(pos, shape)]
        dev = mesh.device_of(pos)
        if isinstance(block, np.ndarray):
            shards.append(torch.from_numpy(np.ascontiguousarray(block)).to(dev))
        else:
            shards.append(torch.as_tensor(block).to(dev).contiguous())
    return Placed(shards, sharding, shape)


def shard_panel(y, x, mask, mesh: Mesh, axis_name: str = "firms"):
    """Pad the firm axis to the mesh size (NaN values, False masks) and
    place ``y`` (T, N), ``x`` (T, N, P) and ``mask`` (T, N) firm-sharded."""
    d = mesh.shape[axis_name]
    y = pad_to_multiple(y, axis=1, multiple=d, fill=float("nan"))
    x = pad_to_multiple(x, axis=1, multiple=d, fill=float("nan"))
    mask = pad_to_multiple(mask, axis=1, multiple=d, fill=False)
    s2 = NamedSharding(mesh, P(None, axis_name))
    s3 = NamedSharding(mesh, P(None, axis_name, None))
    return place_global(y, s2), place_global(x, s3), place_global(mask, s2)


def mesh_devices_setting() -> int:
    """The ``MESH_DEVICES`` setting (default 1): 1 = no mesh, 0 = every
    device, N = exactly N."""
    from fm_returnprediction_tpu_torch.settings import config

    return config("MESH_DEVICES")


def default_mesh(axis_name: str = "firms", device=None) -> Optional[Mesh]:
    """The configured compute mesh, or None for one device: ``MESH_DEVICES``
    1 (the default) → None, 0 → every device of ``local_devices(device)``,
    N → exactly N (raising when there are fewer)."""
    want = mesh_devices_setting()
    n = len(local_devices(device)) if want == 0 else want
    if n <= 1:
        return None
    return make_mesh(n_devices=n, axis_name=axis_name, device=device)


def pipeline_mesh(device=None) -> Optional[Mesh]:
    """The one mesh policy of the pipeline: in a run across processes
    (``torch.distributed`` up with more than one rank) the months × firms
    hierarchy, one mesh row per process; else ``default_mesh``."""
    from fm_returnprediction_tpu_torch.parallel import multihost

    if multihost.process_count() > 1:
        return multihost.make_mesh_2d(device=device)
    return default_mesh(device=device)


# -- collectives ---------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor)


def _leaves(tree) -> list:
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in _leaves(node)]
    raise TypeError(f"collective payloads are tensors or tuples of them, got {type(tree)}")


def _rebuild(tree, leaves: list):
    it = iter(leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        vals = [build(v) for v in node]
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    return build(tree)


def _values(mesh: Mesh, parts: list, axis: str) -> Dict[int, list]:
    """Every member's leaves that this process's groups along ``axis``
    need, by flat position: the local ones, and (for a group that spans
    processes) every rank's by ``torch.distributed.all_gather`` of their
    bytes, each landing on this process's first device."""
    local = mesh.local_positions()
    values = {pos: _leaves(part) for pos, part in zip(local, parts)}
    if not mesh.spans_processes(axis):
        return values
    import torch.distributed as dist

    world = dist.get_world_size()
    on_gloo = dist.get_backend() == "gloo"
    home = mesh.device_of(local[0])
    n_leaves = len(values[local[0]])
    for leaf in range(n_leaves):
        mine = torch.stack([values[pos][leaf] for pos in local])
        blob = mine.contiguous().view(-1).view(torch.uint8)
        send = blob.cpu() if on_gloo else blob
        got = [torch.empty_like(send) for _ in range(world)]
        dist.all_gather(got, send)
        for rank in range(world):
            positions = [i for i, p in enumerate(mesh.processes.flat) if p == rank]
            if rank == _rank():
                continue
            theirs = got[rank].to(home).view(mine.dtype).view(mine.shape)
            for j, pos in enumerate(positions):
                values.setdefault(pos, [None] * n_leaves)[leaf] = theirs[j]
    return values


def _group_of(mesh: Mesh, axis: str) -> Dict[int, List[int]]:
    return {pos: group for group in mesh.axis_groups(axis) for pos in group}


def psum(mesh: Mesh, parts: list, axis: str) -> list:
    """Sum ``parts`` (one tensor, or tuple of tensors, per local position)
    over ``axis``: each group's members added in axis order on the device
    of its first local member, the total handed to every member on its own
    device (the same tensor where the device is the same)."""
    COLLECTIVES[("psum", axis)] += 1
    values = _values(mesh, parts, axis)
    group_of = _group_of(mesh, axis)
    totals: Dict[tuple, list] = {}
    out = []
    for pos, part in zip(mesh.local_positions(), parts):
        group = tuple(group_of[pos])
        if group not in totals:
            home = mesh.device_of(pos)
            acc = [v.to(home) for v in values[group[0]]]
            for member in group[1:]:
                acc = [a + v.to(home) for a, v in zip(acc, values[member])]
            totals[group] = acc
        dev = mesh.device_of(pos)
        out.append(_rebuild(part, [t.to(dev) for t in totals[group]]))
    return out


def all_gather(mesh: Mesh, parts: list, axis: str) -> list:
    """Each group's members stacked along a new leading axis in axis order,
    handed to every member on its own device."""
    COLLECTIVES[("all_gather", axis)] += 1
    values = _values(mesh, parts, axis)
    group_of = _group_of(mesh, axis)
    stacks: Dict[tuple, list] = {}
    out = []
    for pos, part in zip(mesh.local_positions(), parts):
        group = tuple(group_of[pos])
        if group not in stacks:
            home = mesh.device_of(pos)
            stacks[group] = [torch.stack([values[m][k].to(home) for m in group])
                             for k in range(len(values[pos]))]
        dev = mesh.device_of(pos)
        out.append(_rebuild(part, [s.to(dev) for s in stacks[group]]))
    return out


def ppermute(mesh: Mesh, parts: list, axis: str, pairs: Sequence[Tuple[int, int]]) -> list:
    """Move each member's value to another coordinate of its group:
    ``pairs`` are ``(source, destination)`` axis coordinates; a member no
    pair sends to receives zeros."""
    COLLECTIVES[("ppermute", axis)] += 1
    values = _values(mesh, parts, axis)
    group_of = _group_of(mesh, axis)
    source_of = {dst: src for src, dst in pairs}
    k = mesh.axis_names.index(axis)
    out = []
    for pos, part in zip(mesh.local_positions(), parts):
        dev = mesh.device_of(pos)
        coord = mesh.coords(pos)[k]
        src = source_of.get(coord)
        if src is None:
            leaves = [torch.zeros_like(v) for v in values[pos]]
        else:
            leaves = [v.to(dev) for v in values[group_of[pos][src]]]
        out.append(_rebuild(part, leaves))
    return out


def axis_index(mesh: Mesh, axis: str) -> List[int]:
    """Each local position's coordinate along ``axis``."""
    k = mesh.axis_names.index(axis)
    return [mesh.coords(pos)[k] for pos in mesh.local_positions()]
