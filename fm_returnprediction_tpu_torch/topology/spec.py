"""Declarative topology shape: WHAT should be running, as data.

One frozen dataclass names every supervised member kind — router/ingress
(the fleet's submit path), replicas (thread or process, with the process
data plane's transport), the grid worker pool, and the exchange broker —
so the controller, the journal's topology marks, and crash-restart
recovery all speak the same shape language. The reference package's spec,
mark for mark: a journal either package wrote names the same shape. The spec is the unit that
rides the journal (``to_mark``/``from_mark`` round-trip through plain
JSON-able dicts), which is what lets ``TopologyController.recover``
rebuild ANY declared shape from the marks alone.

Env resolution (``from_env``): ``FMRP_TOPO_REPLICAS``,
``FMRP_TOPO_REPLICA_MODE`` (thread|process),
``FMRP_TOPO_TRANSPORT`` (shm|socket, process mode's data plane),
``FMRP_TOPO_GRID_PROCS`` (0 = no grid pool),
``FMRP_TOPO_GRID_TRANSPORT`` (shm|frames).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional

__all__ = ["TopologySpec"]

_REPLICA_MODES = ("thread", "process")
_FLEET_TRANSPORTS = (None, "shm", "socket")
_GRID_TRANSPORTS = (None, "shm", "frames")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The declared inventory: counts per member kind + transports.

    ``replicas`` — serving replicas behind the router (>= 1).
    ``replica_mode`` — ``thread`` (in-process) or ``process`` (spawned
    children; the mode every SIGKILL/liveness story needs).
    ``transport`` — process-replica data plane: ``shm`` rings or the
    ``socket`` oracle; ``None`` defers to ``FMRP_FLEET_TRANSPORT``.
    ``grid_procs`` — spec-grid contraction workers (0 = no pool; a pool
    also implies ONE embedded exchange broker, rank 0 in the parent).
    ``grid_transport`` — the pool's data plane (``shm``/``frames``;
    ``None`` defers to ``FMRP_GRID_TRANSPORT``).
    """

    replicas: int = 2
    replica_mode: str = "thread"
    transport: Optional[str] = None
    grid_procs: int = 0
    grid_transport: Optional[str] = None

    def __post_init__(self):
        if int(self.replicas) < 1:
            raise ValueError("a topology needs at least one replica")
        if self.replica_mode not in _REPLICA_MODES:
            raise ValueError(
                f"replica_mode {self.replica_mode!r} is not "
                f"{'|'.join(_REPLICA_MODES)}"
            )
        if self.transport not in _FLEET_TRANSPORTS:
            raise ValueError(
                f"transport {self.transport!r} is not shm|socket|None"
            )
        if self.transport is not None and self.replica_mode != "process":
            raise ValueError(
                "transport only applies to process replicas"
            )
        if int(self.grid_procs) < 0:
            raise ValueError("grid_procs must be >= 0")
        if self.grid_transport not in _GRID_TRANSPORTS:
            raise ValueError(
                f"grid_transport {self.grid_transport!r} is not "
                f"shm|frames|None"
            )

    # -- the member inventory (what the controller supervises) -----------

    @property
    def brokers(self) -> int:
        """Embedded exchange brokers: one per grid pool (rank 0)."""
        return 1 if self.grid_procs else 0

    def counts(self) -> Dict[str, int]:
        """kind → declared count (the inventory table's first column)."""
        return {
            "router": 1,
            f"replica_{self.replica_mode}": int(self.replicas),
            "grid_worker": int(self.grid_procs),
            "broker": self.brokers,
        }

    # -- journal round-trip ----------------------------------------------

    def to_mark(self) -> Dict[str, object]:
        """Plain JSON-able dict for the journal's ``topology`` mark."""
        return {
            "replicas": int(self.replicas),
            "replica_mode": self.replica_mode,
            "transport": self.transport,
            "grid_procs": int(self.grid_procs),
            "grid_transport": self.grid_transport,
        }

    @classmethod
    def from_mark(cls, mark: Mapping[str, object]) -> "TopologySpec":
        return cls(
            replicas=int(mark.get("replicas", 1)),
            replica_mode=str(mark.get("replica_mode", "thread")),
            transport=mark.get("transport") or None,
            grid_procs=int(mark.get("grid_procs", 0)),
            grid_transport=mark.get("grid_transport") or None,
        )

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "TopologySpec":
        env = os.environ if environ is None else environ

        def _get(key: str, default: str) -> str:
            return (env.get(key, "") or "").strip() or default

        return cls(
            replicas=int(_get("FMRP_TOPO_REPLICAS", "2")),
            replica_mode=_get("FMRP_TOPO_REPLICA_MODE", "thread").lower(),
            transport=_get("FMRP_TOPO_TRANSPORT", "").lower() or None,
            grid_procs=int(_get("FMRP_TOPO_GRID_PROCS", "0")),
            grid_transport=(_get("FMRP_TOPO_GRID_TRANSPORT", "").lower()
                            or None),
        )
