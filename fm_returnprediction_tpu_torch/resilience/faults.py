"""Deterministic fault injection: named fault sites and the plans that
trigger them.

Production code carries NAMED FAULT SITES::

    from fm_returnprediction_tpu_torch.resilience.faults import fault_site
    fault_site("pipeline.table_2")                  # may raise or stall
    panel = fault_site("pipeline.panel", payload=panel)  # may poison
    fault_site("cache.save_array_bundle", path=written)  # may corrupt

With no :class:`FaultPlan` installed, ``fault_site`` is one module-global
read and an immediate return. A test installs a plan::

    with FaultPlan({"pipeline.serving_state": FaultSpec(times=1)}):
        run_pipeline(...)       # raises InjectedFault at that stage, once

A spec triggers by CALL COUNT (``skip`` then ``times``) or, with
``probability``, by a seeded hash of (plan seed, site, call number) —
never by the clock or a global RNG — so a failing run replays exactly.
The plan records every site visit (``calls``) and every triggered fault
(``fired``).

The sites of the port: ``pipeline.panel`` (payload: the enriched panel,
before its contract), ``pipeline.<stage>`` for the checkpointable stages
(``table_1``, ``table_2``, ``decile_table``, ``serving_state``,
``specgrid_scenarios``),
``cache.write_cache_data`` and ``cache.save_array_bundle`` (path: the file
just written), ``serving.ingest`` (payload: the ``(y, x, mask)``
cross-section offered to ``ERService.ingest_month``, before its
validation: where :func:`poison_nan_flood` and :func:`poison_scale_spike`
are injected), and ``serving.dispatch`` and ``fleet.replica_stall``
(payload: the replica's label, None outside a fleet) inside a serving
bucket dispatch, where a stall is what the dispatch watchdog sees; and the
serving fleet's ``fleet.replica_kill``, ``fleet.swap_mid_flight``,
``fleet.poison_state``, ``fleet.hard_crash`` and
``fleet.journal_torn_tail`` (their mutators are below); and in spawned
processes ``dist.broker_round`` (the exchange broker, mid-round),
``grid.rank_death`` (a spec-grid worker with its job received),
``replica.result_send`` and ``replica.verb`` (a replica child over the
socket), ``shm.ring.commit`` (between a ring frame's payload and its
commit word), ``serving.shm.doorbell_fd`` and ``obs.annex_mirror``.

The declarative part of a plan serializes into
``FMRP_CHAOS_PLAN``/``FMRP_CHAOS_SEED`` (:func:`chaos_env`), which every
spawner (the grid worker pool, the process replicas) merges into its
child's environment and the child installs with
:func:`install_plan_from_env`; ``FaultSpec.proc`` restricts a spec to the
child whose ``FMRP_DIST_PROC_ID`` or ``FMRP_PROC_INDEX`` equals it, and
``FaultSpec.sigkill`` kills that child at the site. The semantics are the
reference package's.
"""

from __future__ import annotations

import builtins
import dataclasses
import hashlib
import json
import os
import signal
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from fm_returnprediction_tpu_torch.resilience.errors import InjectedFault

__all__ = [
    "FaultSpec",
    "FaultPlan",
    "fault_site",
    "chaos_env",
    "install_plan_from_env",
    "truncate_file",
    "poison_nan_flood",
    "poison_scale_spike",
    "corrupt_panel_duplicate_id",
    "corrupt_panel_permute_firms",
    "corrupt_panel_stale_month",
    "corrupt_panel_scale_spike",
    "fleet_kill_routed",
    "fleet_stall_replica",
    "fleet_trigger_staged_rollover",
    "fleet_hard_crash",
    "poison_serving_state_nan",
    "tear_journal_tail",
]

# The installed plan: a plain module global, so the inactive path costs one
# read. Installation is guarded by _INSTALL_LOCK, per-site counters by the
# plan's own lock.
_ACTIVE: Optional["FaultPlan"] = None
_INSTALL_LOCK = threading.Lock()


def truncate_file(path: Union[str, Path]) -> None:
    """Default corruption: keep the first half of the file, the torn-write
    shape a crash mid-``write()`` leaves behind."""
    path = Path(path)
    data = path.read_bytes()
    path.write_bytes(data[: max(len(data) // 2, 1)])


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What happens when a named site triggers.

    times       : trigger on this many calls, then heal (-1 = every call).
    skip        : let this many calls through untouched first.
    probability : trigger each eligible call with this probability, decided
                  by a seeded hash of (plan seed, site, call number).
    exc         : exception to raise: a type, an instance, or a zero-argument
                  factory. ``None`` with no other effect raises
                  :class:`InjectedFault`.
    delay_s     : stall this long before any other effect.
    corrupt     : called with the site's ``path`` operand (``True`` selects
                  :func:`truncate_file`).
    mutate      : called with the site's ``payload``, returns the poisoned
                  payload.
    sigkill     : SIGKILL the current process at the site (no cleanup).
    proc        : install only in the child process whose
                  ``FMRP_DIST_PROC_ID`` / ``FMRP_PROC_INDEX`` equals this.
    """

    times: int = 1
    skip: int = 0
    probability: Optional[float] = None
    exc: Union[None, BaseException, type, Callable[[], BaseException]] = None
    delay_s: float = 0.0
    corrupt: Union[None, bool, Callable[[Path], None]] = None
    mutate: Optional[Callable] = None
    sigkill: bool = False
    proc: Optional[str] = None

    def _make_exc(self, site: str) -> BaseException:
        if self.exc is None:
            return InjectedFault(f"injected fault at {site!r}")
        if isinstance(self.exc, BaseException):
            return self.exc
        made = self.exc()  # a type or a factory
        if not isinstance(made, BaseException):
            raise TypeError(f"FaultSpec.exc for {site!r} produced {made!r}")
        return made


class FaultPlan:
    """A set of site → :class:`FaultSpec` rules, installed as a context.

    Plans nest: entering a plan shadows the one installed before it, and
    leaving restores it. ``calls`` counts every visit to an instrumented
    site, ``fired`` the visits that triggered."""

    def __init__(self, specs: Dict[str, FaultSpec], seed: int = 0):
        for site, spec in specs.items():
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"spec for {site!r} must be a FaultSpec")
        self.specs = dict(specs)
        self.seed = int(seed)
        self.calls: Counter = Counter()
        self.fired: Counter = Counter()
        self._lock = threading.Lock()
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        with _INSTALL_LOCK:
            self._prev = _ACTIVE
            _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _INSTALL_LOCK:
            _ACTIVE = self._prev
            self._prev = None

    def _should_fire(self, spec: FaultSpec, call_no: int, site: str) -> bool:
        """``call_no`` is 1-based; a pure function of (plan, site, call)."""
        if call_no <= spec.skip:
            return False
        if spec.probability is not None:
            digest = hashlib.sha256(f"{self.seed}|{site}|{call_no}".encode()).digest()
            return int.from_bytes(digest[:8], "big") / 2**64 < spec.probability
        if spec.times < 0:
            return True
        return call_no - spec.skip <= spec.times

    def _apply(self, site: str, payload, path):
        spec = self.specs.get(site)
        with self._lock:
            self.calls[site] += 1
            call_no = self.calls[site]
            if spec is None or not self._should_fire(spec, call_no, site):
                return payload
            self.fired[site] += 1
        # effects outside the lock: a delay must not serialize other sites
        if spec.delay_s:
            time.sleep(spec.delay_s)
        if spec.sigkill:
            os.kill(os.getpid(), signal.SIGKILL)
        if spec.corrupt is not None and path is not None:
            corruptor = truncate_file if spec.corrupt is True else spec.corrupt
            corruptor(Path(path))
        if spec.mutate is not None:
            payload = spec.mutate(payload)
            if spec.exc is None:
                return payload  # a poisoning site returns, it does not raise
        if spec.exc is not None or (spec.mutate is None and spec.corrupt is None
                                    and not spec.delay_s):
            raise spec._make_exc(site)
        return payload


def fault_site(site: str, payload=None, path=None):
    """The production-side hook: returns ``payload`` (possibly poisoned by
    the active plan); may raise or stall as the plan says. With no plan
    installed this is one global read."""
    plan = _ACTIVE
    if plan is None:
        return payload
    return plan._apply(site, payload, path)


# -- cross-process propagation ----------------------------------------------

_ENV_PLAN = "FMRP_CHAOS_PLAN"
_ENV_SEED = "FMRP_CHAOS_SEED"


def _spec_to_wire(spec: FaultSpec) -> Optional[dict]:
    """The environment-serializable part of one spec, or None when it
    carries a live callable (such specs stay in the parent)."""
    if spec.mutate is not None:
        return None
    if spec.corrupt is not None and spec.corrupt is not True:
        return None
    exc_name: Optional[str] = None
    if spec.exc is not None:
        if not (isinstance(spec.exc, type) and issubclass(spec.exc, BaseException)):
            return None
        exc_name = spec.exc.__name__
    return {"times": spec.times, "skip": spec.skip, "probability": spec.probability,
            "delay_s": spec.delay_s, "corrupt": spec.corrupt is True,
            "sigkill": spec.sigkill, "proc": spec.proc, "exc": exc_name}


def _resolve_exc(name: str) -> type:
    """An exception type by name: builtins first, then the port's
    ``resilience.errors``."""
    got = getattr(builtins, name, None)
    if isinstance(got, type) and issubclass(got, BaseException):
        return got
    from fm_returnprediction_tpu_torch.resilience import errors as _errors

    got = getattr(_errors, name, None)
    if isinstance(got, type) and issubclass(got, BaseException):
        return got
    raise ValueError(f"unknown exception type in chaos env: {name!r}")


def chaos_env(plan: Optional[FaultPlan] = None) -> Dict[str, str]:
    """The environment pair a spawner merges into a child's environment for
    ``plan`` (default: the active plan); empty when nothing serializes."""
    plan = _ACTIVE if plan is None else plan
    if plan is None:
        return {}
    wire = {site: w for site, spec in plan.specs.items()
            if (w := _spec_to_wire(spec)) is not None}
    if not wire:
        return {}
    return {_ENV_PLAN: json.dumps(wire, sort_keys=True), _ENV_SEED: str(plan.seed)}


def install_plan_from_env(environ: Optional[Mapping[str, str]] = None) -> Optional[FaultPlan]:
    """Child-process hook: rebuild and install, for the process's lifetime,
    the plan a parent serialized with :func:`chaos_env`. Specs whose
    ``proc`` is not this process's identity are dropped. Returns the plan,
    or None when the environment carries nothing for this process."""
    env = os.environ if environ is None else environ
    raw = env.get(_ENV_PLAN, "").strip()
    if not raw:
        return None
    seed = int(env.get(_ENV_SEED, "0") or "0")
    me = env.get("FMRP_DIST_PROC_ID") or env.get("FMRP_PROC_INDEX")
    specs: Dict[str, FaultSpec] = {}
    for site, w in json.loads(raw).items():
        if w.get("proc") is not None and w["proc"] != me:
            continue
        specs[site] = FaultSpec(
            times=int(w.get("times", 1)), skip=int(w.get("skip", 0)),
            probability=w.get("probability"),
            exc=_resolve_exc(w["exc"]) if w.get("exc") else None,
            delay_s=float(w.get("delay_s", 0.0)),
            corrupt=True if w.get("corrupt") else None,
            sigkill=bool(w.get("sigkill", False)), proc=w.get("proc"),
        )
    if not specs:
        return None
    plan = FaultPlan(specs, seed=seed)
    plan.__enter__()  # installed for the process's lifetime
    return plan


# -- data-corruption payload mutators ---------------------------------------
#
# Sites that inject bad DATA rather than exceptions: the silent failures the
# guard layer exists to catch. Each mutator is deterministic and returns a
# new object. The panel corruptors act on the enriched panel at
# ``pipeline.panel`` (values a torch tensor, on any device); each is caught
# at its declared severity by ``guard.contracts.check_panel``.


def poison_nan_flood(payload):
    """(y, x, mask) → every predictor NaN while the mask claims full
    presence. Declared catch: ``cs.nan_flood`` at quarantine."""
    y, x, mask = payload
    x = np.asarray(x)
    return (np.full(np.asarray(y).shape, np.nan, dtype=x.dtype),
            np.full(x.shape, np.nan, dtype=x.dtype),
            np.ones(np.asarray(mask).shape, dtype=bool))


def poison_scale_spike(column: int = 0, scale: float = 1e20):
    """Mutator factory: (y, x, mask) with one predictor column scaled into
    f32-Gram overflow territory. Declared catch: ``cs.value_bounds`` at
    quarantine."""

    def mutate(payload):
        y, x, mask = payload
        x = np.array(x, copy=True)
        x[..., column] = x[..., column] * x.dtype.type(scale)
        return y, x, mask

    return mutate


def corrupt_panel_duplicate_id(panel):
    """A duplicated permno in the firm vocabulary. Declared catch:
    ``panel.key_unique`` at fail."""
    ids = np.array(np.asarray(panel.ids), copy=True)
    if len(ids) > 1:
        ids[-1] = ids[0]
    return dataclasses.replace(panel, ids=ids)


def corrupt_panel_permute_firms(panel, seed: int = 0):
    """The firm axis coherently permuted (ids, values and mask together). No
    statistic moves, but the sorted-vocabulary convention breaks. Declared
    catch: ``panel.ids_sorted`` at warn."""
    n = len(panel.ids)
    perm = np.random.default_rng(seed).permutation(n)
    if n > 1 and (perm == np.arange(n)).all():
        perm = np.roll(perm, 1)
    values = panel.values
    return dataclasses.replace(
        panel, ids=np.asarray(panel.ids)[perm],
        values=values[:, torch.as_tensor(perm, device=values.device), :],
        mask=np.asarray(panel.mask)[:, perm])


def corrupt_panel_stale_month(panel):
    """The last calendar entry overwritten with the month before it (a
    stuck feed). Declared catch: ``panel.calendar_monotone`` at fail."""
    months = np.array(np.asarray(panel.months).astype("datetime64[ns]"), copy=True)
    if len(months) > 1:
        months[-1] = months[-2]
    return dataclasses.replace(panel, months=months)


def corrupt_panel_scale_spike(panel, column: int = -1, scale: float = 1e20):
    """One characteristic column scaled past the guard's value bound.
    Declared catch: ``panel.value_bounds`` at fail."""
    values = panel.values.clone()
    values[:, :, column] = values[:, :, column] * scale
    return dataclasses.replace(panel, values=values)


# -- fleet fault mutators ----------------------------------------------------
#
# The serving fleet's fault sites (``serving.fleet``) carry LIVE OBJECTS as
# payloads (the fleet itself, or (fleet, routed replica id)), so a plan can
# act on the fleet's topology at a deterministic point in the request
# stream (the spec's skip/times counters pick WHICH request). Each mutator
# returns the payload unchanged: these sites poison the world, not the data.
#
#   fleet.replica_kill      after a request is in flight on its routed
#                           replica; ``fleet_kill_routed`` kills that replica
#   fleet.replica_stall     at each replica dispatch, with its id;
#                           ``fleet_stall_replica`` stalls one replica
#   fleet.swap_mid_flight   inside the admitted-submit path;
#                           ``fleet_trigger_staged_rollover`` fires the staged
#                           rollover between two specific requests
#   fleet.poison_state      per replica in a rollover's PREPARE;
#                           ``poison_serving_state_nan`` corrupts the candidate
#   fleet.hard_crash        inside the admitted-submit path;
#                           ``fleet_hard_crash`` abandons the whole fleet
#   fleet.journal_torn_tail with the journal's path as a crash drops its
#                           handle; ``tear_journal_tail`` cuts the last line


def fleet_kill_routed(rid: Optional[str] = None):
    """Mutator factory for ``fleet.replica_kill``: kill the replica the
    triggering request was just routed to (payload ``(fleet, routed_rid)``),
    or only when it is ``rid``."""

    def mutate(payload):
        fleet, routed = payload
        if rid is None or routed == rid:
            fleet.kill_replica(routed, reason="chaos: fleet.replica_kill")
        return payload

    return mutate


def fleet_stall_replica(rid: str, delay_s: float):
    """Mutator factory for ``fleet.replica_stall``: stall exactly one
    replica's dispatches (the payload is the dispatching replica's id)."""

    def mutate(payload):
        if payload == rid:
            time.sleep(delay_s)
        return payload

    return mutate


def fleet_trigger_staged_rollover(payload):
    """Mutator for ``fleet.swap_mid_flight``: fire the fleet's staged state
    rollover now, from inside the submit path."""
    payload.trigger_staged_rollover()
    return payload


def fleet_hard_crash(payload):
    """Mutator for ``fleet.hard_crash``: abandon the fleet mid-load as a
    process death would (no drain, no journal terminals)."""
    payload.hard_crash()
    return payload


def tear_journal_tail(path: Union[str, Path]) -> None:
    """Corruptor for ``fleet.journal_torn_tail``: cut the journal's final
    line in half, the shape a crash in the middle of an append leaves."""
    path = Path(path)
    data = path.read_bytes().rstrip(b"\n")
    if not data:
        return
    nl = data.rfind(b"\n")
    last = data[nl + 1:]
    path.write_bytes(data[: nl + 1] + last[: max(len(last) // 2, 1)])


def poison_serving_state_nan(state):
    """A rollover candidate whose every lagged coefficient is NaN. Declared
    catch: the fleet's candidate validation in PREPARE
    (``StateRolloverError``, no replica flipped)."""
    return dataclasses.replace(
        state,
        slopes_bar=np.full_like(np.asarray(state.slopes_bar), np.nan),
        intercept_bar=np.full_like(np.asarray(state.intercept_bar), np.nan),
    )
