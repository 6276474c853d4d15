"""Crash-restart recovery: rebuild a fleet from its journal + the registry.

The fleet's journal proves exactly-once WITHIN a process lifetime.
This module extends the proof ACROSS a process death: a hard crash leaves
behind (a) a journal whose tail may be torn mid-append and whose admitted
requests may have no terminal, and (b) the artifact/executable registry,
which already holds everything needed to serve again — the newest
published ``ServingState`` and the kernel libraries. Recovery is three
write-ahead-honest steps:

1. **Repair the tail.** A torn final line means the crash hit mid-append;
   by the write-ahead discipline the action it would have recorded never
   proceeded, so truncating to the last complete line is sound WAL
   recovery (atomic tmp+replace; bytes/lines dropped are disclosed, never
   silently skipped).
2. **Close out the in-flight.** Every admitted-but-not-terminal request is
   resolved to a TYPED RETRIABLE outcome: an ``error`` terminal naming
   :class:`~fm_returnprediction_tpu_torch.resilience.errors.RecoveredInFlightError`
   with ``retriable=true`` is appended for each (their futures died with
   the process; quoting is read-only, so a resubmit can never
   double-serve), plus a ``recovered`` mark. The closed-out session then
   REPLAYS CLEAN — zero dropped, zero duplicated — which is the
   exactly-once verdict extended across the death.
3. **Rebuild the fleet.** ``ServingFleet.recover`` resolves the state from
   the registry's artifact plane (or an explicit state), sizes the fleet
   from the journal's own topology marks (``fleet_start`` / ``scale_*`` /
   retention all record ``size=``), and spawns every replica through the
   warm pool (no build, ``WarmReport`` evidence) onto the SAME journal
   path, which rotates the recovered session like any other. In one
   process the crashed fleet's replicas are fenced before the new fleet
   quotes (``ServingFleet.hard_crash``).

Chaos sites: ``fleet.hard_crash`` (abandon the fleet mid-load, no drain,
no terminals) and ``fleet.journal_torn_tail`` (tear the journal's final
line as the crash drops the file handle) exercise exactly this path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

from fm_returnprediction_tpu_torch.serving.journal import replay_journal

__all__ = [
    "RecoveredRequest",
    "JournalRecovery",
    "RecoveryReport",
    "repair_journal",
    "recover_journal",
]

_TERMINAL = ("done", "error", "shed")


@dataclasses.dataclass(frozen=True)
class RecoveredRequest:
    """One in-flight-at-crash request, closed out as retriable."""

    req: int
    last_event: str            # admit | route | requeue
    replica: Optional[str]     # where it was last routed (None: never)


@dataclasses.dataclass(frozen=True)
class JournalRecovery:
    """What journal repair + close-out did (step 1 and 2 evidence)."""

    path: Path
    torn_lines: int            # trailing unparseable lines truncated
    torn_bytes: int
    recovered: Tuple[RecoveredRequest, ...]
    replay_clean: bool         # the closed-out session replays clean
    n_admitted: int
    n_done: int
    n_shed: int
    last_size: Optional[int]   # fleet size from the latest size mark
    last_topology: Optional[dict] = None  # latest full ``topology`` mark
    #   (the TopologySpec as a plain dict) — what lets the topology
    #   controller rebuild ANY declared shape, not just a replica count


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """The full ``ServingFleet.recover`` verdict (journal + rebuild)."""

    journal: JournalRecovery
    state_source: str          # "registry:<root>" | "explicit"
    n_replicas: int
    zero_compile_starts: int   # replicas that started fully warm-pool
    rotated_to: Optional[Path]  # where the recovered session now lives
    prior_sessions: Tuple[str, ...]  # retained session file names (the
    #   recovered session's verdict is journal.replay_clean — rotation
    #   renames, it does not rewrite)

    @property
    def clean(self) -> bool:
        return self.journal.replay_clean


def repair_journal(path: Union[str, Path]) -> Tuple[int, int]:
    """Truncate trailing unparseable lines (torn writes) off a journal.

    Returns ``(lines_dropped, bytes_dropped)``. Only the TAIL is
    repaired — write-ahead appends mean a crash can tear at most the
    final write; an unparseable INTERIOR line is real corruption and is
    left for replay to flag. Atomic (tmp + ``os.replace``)."""
    path = Path(path)
    raw = path.read_bytes()
    if not raw:
        return 0, 0
    lines = raw.split(b"\n")
    kept = len(lines)
    while kept > 0:
        tail = lines[kept - 1].strip()
        if not tail:
            kept -= 1
            continue
        try:
            json.loads(tail)
            break
        except json.JSONDecodeError:
            kept -= 1
    repaired = b"".join(ln + b"\n" for ln in lines[:kept] if ln.strip())
    if repaired == raw:
        return 0, 0
    if repaired == raw + b"\n":
        # sound records, missing only the final newline (a crash that cut
        # between the JSON bytes and the "\n"): nothing torn — but the
        # newline MUST be restored, because close-out appends events to
        # this file and would otherwise concatenate onto the last record,
        # corrupting the very journal being repaired
        with open(path, "ab") as fh:
            fh.write(b"\n")
            fh.flush()
            os.fsync(fh.fileno())
        return 0, 0
    dropped_lines = sum(1 for ln in lines[kept:] if ln.strip())
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name, suffix=".repair")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(repaired)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return dropped_lines, max(len(raw) - len(repaired), 0)


def _scan(path: Path):
    """(events, last_seq) — the journal's parsed lines, seq-ordered.
    Interior corruption (not the repaired tail) is skipped here so
    close-out can still proceed; the final ``replay_journal`` pass flags
    it and the recovery reports ``replay_clean=False``."""
    events = []
    for line in path.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    events.sort(key=lambda e: e.get("seq", 0))
    last_seq = max((e.get("seq", 0) for e in events), default=0)
    return events, last_seq


def recover_journal(path: Union[str, Path]) -> JournalRecovery:
    """Steps 1+2: repair the torn tail, close out in-flight requests to
    typed retriable terminals, and verify the session replays clean."""
    path = Path(path)
    torn_lines, torn_bytes = repair_journal(path)
    events, last_seq = _scan(path)
    # per-request last non-terminal event + replica (for the disclosure)
    state: Dict[int, Tuple[str, Optional[str]]] = {}
    terminal: Dict[int, bool] = {}
    last_size: Optional[int] = None
    last_topology: Optional[dict] = None
    for e in events:
        ev = e.get("ev")
        if ev == "mark":
            if e.get("size") is not None:
                last_size = int(e["size"])
            if e.get("label") == "topology" and e.get("topo"):
                try:
                    last_topology = json.loads(e["topo"])
                except (json.JSONDecodeError, TypeError):
                    pass  # a torn topo payload degrades to size-only
            continue
        req = e.get("req")
        if req is None:
            continue
        if ev in _TERMINAL:
            terminal[req] = True
        elif ev in ("admit", "route", "requeue"):
            prev = state.get(req, (ev, None))
            state[req] = (ev, e.get("replica", prev[1]))
    dangling = sorted(r for r in state if not terminal.get(r))
    recovered = tuple(
        RecoveredRequest(req=r, last_event=state[r][0], replica=state[r][1])
        for r in dangling
    )
    if recovered or torn_lines:
        with open(path, "a", encoding="utf-8") as fh:
            for rec in recovered:
                last_seq += 1
                fh.write(json.dumps({
                    "ev": "error", "req": rec.req, "seq": last_seq,
                    "error": "RecoveredInFlightError: in flight at process "
                             "death; read-only quote — safe to resubmit",
                    "retriable": True, "recovered": True,
                }, sort_keys=True) + "\n")
            last_seq += 1
            fh.write(json.dumps({
                "ev": "mark", "label": "recovered", "seq": last_seq,
                "closed_out": len(recovered), "torn_lines": torn_lines,
                "torn_bytes": torn_bytes,
            }, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
    replay = replay_journal(path)
    return JournalRecovery(
        path=path,
        torn_lines=torn_lines,
        torn_bytes=torn_bytes,
        recovered=recovered,
        replay_clean=replay.clean,
        n_admitted=replay.n_admitted,
        n_done=replay.n_done,
        n_shed=replay.n_shed,
        last_size=last_size,
        last_topology=last_topology,
    )
