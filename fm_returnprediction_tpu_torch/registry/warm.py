"""Warm-pool protocol: a fresh replica reaches quoting-ready without a
build.

:func:`warm_from_registry` starts a fully warmed
:class:`~fm_returnprediction_tpu_torch.serving.service.ERService` whose
state comes from the registry's artifact plane (or an explicit state or
path), and returns a :class:`WarmReport` with the evidence of what the
warm-up paid for.

"Compile-free" means what it means everywhere in the port: no nvcc build
inside the window, as the build-cache sentinel
(``telemetry.perf.recompile_watch``) shows. The kernel libraries a build
would produce come from the registry's executable plane
(``registry.executables``). The bucket programs are CUDA graphs, which
are per process and cannot be stored or fetched: each warm-up captures
them afresh, and the report counts those captures in a field of their
own. ``strict=True`` raises on a build in the window, never on a capture.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

__all__ = ["WarmReport", "warm_from_registry"]

# serializes the evidence window: two warm-ups racing in one process would
# count each other's ledger records (failover, scale-out and recovery all
# spawn through here)
_WARM_LOCK = threading.Lock()

_PROGRAM = "serving_bucket"


@dataclasses.dataclass(frozen=True)
class WarmReport:
    """Evidence of how a warm-up was paid for."""

    wall_s: float
    builds: int                # nvcc builds in the window (build-cache growth)
    fetched: int               # kernel libraries the registry answered in it
    captures: int              # bucket programs built (graph captures on the card)
    programs: Tuple[str, ...]  # "program@provenance" per ledger record
    saved_s: float             # store-time build seconds the fetches did not pay

    @property
    def zero_compile(self) -> bool:
        """The warm-pool contract: nothing was built."""
        return self.builds == 0


def warm_from_registry(
    state=None,
    registry_dir=None,
    fingerprint: Optional[str] = None,
    strict: bool = False,
    service_cls=None,
    **service_kwargs,
):
    """Build a quoting-ready ``ERService`` from the registry.

    ``state`` may be a fitted ``ServingState``, a path to a saved
    ``serving_state.npz``, or None, in which case the artifact plane
    resolves it (by ``fingerprint``, else the newest registered entry).
    ``registry_dir`` overrides ``FMRP_REGISTRY_DIR`` for the warm-up.
    ``service_cls`` substitutes an ``ERService`` subclass (the fleet's
    replica class); ``service_kwargs`` go to its constructor (``device``
    among them).

    Returns ``(service, report)``. ``strict=True`` closes the service and
    raises when the window saw a build."""
    from pathlib import Path

    from fm_returnprediction_tpu_torch.registry import artifacts as _artifacts
    from fm_returnprediction_tpu_torch.registry.store import using_registry
    from fm_returnprediction_tpu_torch.serving.service import ERService
    from fm_returnprediction_tpu_torch.serving.state import ServingState
    from fm_returnprediction_tpu_torch.telemetry import cost_ledger, recompile_watch

    with using_registry(registry_dir) as reg:
        if state is None:
            if reg is None:
                raise ValueError(
                    "warm_from_registry needs a state, a registry_dir, or "
                    "FMRP_REGISTRY_DIR set")
            state = _artifacts.load_serving_state(fingerprint, registry=reg)
            if state is None:
                raise FileNotFoundError(f"no serving_state artifact in registry {reg.root}")
        elif isinstance(state, (str, Path)):
            state = ServingState.load(state)

        cls = service_cls if service_cls is not None else ERService
        ledger = cost_ledger()
        with _WARM_LOCK:
            seq0 = ledger.last_seq
            t0 = time.perf_counter()
            with recompile_watch("warm_from_registry", warm=True) as watch:
                service = cls(state, warm=True, **service_kwargs)
            wall = time.perf_counter() - t0
            window = ledger.since(seq0)
    buckets = [r for r in window if r.program == _PROGRAM]
    fetched = [r for r in window if r.provenance == "fetched"]
    report = WarmReport(
        wall_s=wall,
        builds=watch.grew,
        fetched=len(fetched),
        captures=len(buckets),
        programs=tuple(f"{r.program}@{r.provenance}" for r in window),
        saved_s=sum(r.saved_s for r in fetched if r.saved_s is not None),
    )
    if strict and not report.zero_compile:
        service.close()
        raise RuntimeError(
            "warm_from_registry(strict=True): the warm-up built a kernel "
            f"(builds={report.builds}, programs={list(report.programs)})")
    return service, report
