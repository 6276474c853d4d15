"""Write-ahead request journal + deterministic replay verifier.

The fleet's correctness claim — "no in-flight request is dropped or
double-served across a state swap or a replica death" — is PROVED, not
asserted: every admission-controlled request writes its lifecycle into an
append-only JSONL journal BEFORE the action it records proceeds
(write-ahead discipline), and :func:`replay_journal` replays the file
through a per-request finite state machine after the fact. A clean replay
is machine-checkable evidence that each admitted request reached exactly
one terminal outcome; a dropped or duplicated request is a named,
countable violation — the same stance as the guard layer's audit records.

Event vocabulary (one JSON object per line, ``seq`` totally ordered by
the journal's lock):

======== ==================================================================
``admit``    request passed admission control (written BEFORE routing)
``shed``     admission refused it — terminal; 429-style, never routed
             (also terminal AFTER ``admit`` when every healthy replica's
             queue refused the request)
``route``    request handed to a replica's microbatcher (``replica=``)
``requeue``  its replica failed it mid-flight (death/stall); the fleet is
             about to route it again — the ONLY event that licenses a
             second ``route``
``done``     answered (terminal; carries no payload — results stay on the
             caller's future)
``error``    failed permanently (terminal; ``error=`` repr)
``mark``     fleet-level annotation outside any request — rollover
             begin/commit/abort, replica kill/drain/failover — so a replay
             can segment phases ("during the swap window")
======== ==================================================================

The event names and JSON keys are the reference package's: a journal
either package writes replays in the other.

Legal per-request sequences::

    admit (route (requeue route)*)? (done | error | shed)
    shed                                       # refused at the front door

Anything else — a second terminal, a ``route`` not licensed by ``admit``
or ``requeue``, an admitted request with no terminal — lands in the
replay's violation lists. Replay is a pure function of the file bytes:
replaying the same journal twice gives identical verdicts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

__all__ = ["RequestJournal", "JournalReplay", "replay_journal"]

_TERMINAL = ("done", "error", "shed")


class RequestJournal:
    """Append-only, thread-safe JSONL journal with write-ahead flushing.

    Every :meth:`append` serializes, writes and FLUSHES the line under the
    journal lock before returning, so the record is on its way to disk
    before the action it describes proceeds — the ordering that makes the
    replay's verdict about the fleet rather than about buffering luck.
    ``seq`` is assigned under the same lock: the journal's total order is
    the authoritative interleaving for replay.
    """

    def __init__(self, path: Union[str, Path], keep: Optional[int] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # one file = one journal session. Request ids and ``seq`` restart
        # with every fleet, so APPENDING a new session to an old file
        # would make replay see colliding ids as duplicates — a perfectly
        # healthy fleet failing its own exactly-once proof. A pre-existing
        # non-empty file (a reused FMRP_FLEET_JOURNAL path) therefore
        # ROTATES to ``<path>.1`` / ``.2`` / … first: history is kept,
        # every file replays standalone. ``rotated_to`` discloses it.
        # The suffix is max(existing)+1 — monotone even after retention
        # deletes low-numbered sessions, so numeric order stays age order.
        self.rotated_to: Optional[Path] = None
        # retention: keep the newest ``keep`` rotated sessions (the live
        # file is never touched); 0 = keep all. Default from
        # FMRP_FLEET_JOURNAL_KEEP (8). Applied AT ROTATION TIME so an idle
        # journal never loses history, and the dropped files are disclosed
        # (``dropped_sessions`` + a ``journal_retention`` mark in the new
        # session — replay tolerates marks).
        if keep is None:
            keep = int(os.environ.get("FMRP_FLEET_JOURNAL_KEEP", "8"))
        self.keep = int(keep)
        self.dropped_sessions: Tuple[Path, ...] = ()
        sessions = self.sessions()
        if self.path.exists() and self.path.stat().st_size > 0:
            k = (sessions[-1][0] + 1) if sessions else 1
            self.rotated_to = self.path.with_name(f"{self.path.name}.{k}")
            self.path.rename(self.rotated_to)
            sessions.append((k, self.rotated_to))
        if self.keep > 0 and len(sessions) > self.keep:
            doomed = [p for _, p in sessions[: len(sessions) - self.keep]]
            for p in doomed:
                try:
                    p.unlink()
                except OSError:
                    continue
            self.dropped_sessions = tuple(doomed)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False
        if self.dropped_sessions:
            self.mark(
                "journal_retention",
                keep=self.keep,
                dropped=";".join(p.name for p in self.dropped_sessions),
            )

    def sessions(self) -> List[Tuple[int, Path]]:
        """Existing rotated session files as sorted (suffix, path)."""
        out: List[Tuple[int, Path]] = []
        for p in self.path.parent.glob(f"{self.path.name}.*"):
            suffix = p.name[len(self.path.name) + 1:]
            if suffix.isdigit():
                out.append((int(suffix), p))
        out.sort()
        return out

    def append(self, ev: str, req: Optional[int] = None, **fields) -> int:
        """Write one event line; returns its ``seq``. No-op (returns -1)
        after close — a late done-callback racing a shutdown must not
        crash the flusher thread that carries it.

        ``FMRP_OBS_JOURNAL_TS=1`` stamps each record with ``t_ns``
        (``perf_counter_ns`` — the span clock, so the timeline CLI can
        join journal FSM records against merged traces on one axis).
        OFF by default: journal bytes stay deterministic, which the
        replay/recovery tests compare."""
        record = {"ev": str(ev)}
        if req is not None:
            record["req"] = int(req)
        if os.environ.get("FMRP_OBS_JOURNAL_TS", "").strip().lower() in (
                "1", "true", "yes", "on"):
            import time

            record["t_ns"] = time.perf_counter_ns()
        for k, v in sorted(fields.items()):
            if v is not None:
                record[k] = v
        with self._lock:
            if self._closed:
                return -1
            self._seq += 1
            record["seq"] = self._seq
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
            self._fh.flush()
            return self._seq

    def mark(self, label: str, **fields) -> int:
        """Fleet-level annotation (rollover/kill/failover phase markers)."""
        return self.append("mark", label=label, **fields)

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._fh.close()

    def abandon(self) -> None:
        """Crash-simulating close (the ``fleet.hard_crash`` path): drop
        the file handle with no close-out and no rotation — later
        :meth:`append` calls no-op, exactly what a dead process's journal
        looks like to the next one. Mechanically :meth:`close`; the
        separate verb keeps the journal's lifecycle its own concern
        instead of callers poking ``_fh``/``_closed``."""
        self.close()

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass(frozen=True)
class JournalReplay:
    """The replay verdict: counts plus every named violation."""

    n_events: int
    n_admitted: int
    n_done: int
    n_error: int
    n_shed: int
    n_routes: int
    n_requeues: int
    marks: Tuple[dict, ...]
    dropped: Tuple[int, ...]       # admitted, no terminal (lost in flight)
    duplicated: Tuple[int, ...]    # >1 terminal — double-served/double-failed
    invalid: Tuple[str, ...]       # sequence violations, human-readable

    @property
    def zero_dropped(self) -> bool:
        return not self.dropped

    @property
    def zero_duplicated(self) -> bool:
        return not self.duplicated

    @property
    def clean(self) -> bool:
        """The full exactly-once verdict: nothing dropped, nothing
        duplicated, no illegal transition anywhere in the journal."""
        return self.zero_dropped and self.zero_duplicated and not self.invalid


def replay_journal(path: Union[str, Path]) -> JournalReplay:
    """Deterministically replay a journal file through the per-request FSM.

    Pure function of the file bytes; tolerant of nothing — a torn final
    line (crash mid-write) is reported as an ``invalid`` entry rather
    than silently skipped, because a WAL whose tail can vanish silently
    proves nothing."""
    events: List[dict] = []
    invalid: List[str] = []
    raw = Path(path).read_text(encoding="utf-8")
    for lineno, line in enumerate(raw.splitlines(), start=1):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            invalid.append(f"line {lineno}: unparseable (torn write?)")
    events.sort(key=lambda e: e.get("seq", 0))

    marks: List[dict] = []
    # per-request state: "admitted" | "routed" | "requeued" | terminal name
    state: Dict[int, str] = {}
    terminals: Dict[int, int] = {}
    counts = {"admit": 0, "done": 0, "error": 0, "shed": 0,
              "route": 0, "requeue": 0}
    for e in events:
        ev = e.get("ev")
        if ev == "mark":
            marks.append(e)
            continue
        req = e.get("req")
        if req is None:
            invalid.append(f"seq {e.get('seq')}: {ev!r} without req id")
            continue
        cur = state.get(req)
        if ev == "admit":
            counts["admit"] += 1
            if cur is not None:
                invalid.append(f"req {req}: admitted twice")
            state[req] = "admitted"
        elif ev == "route":
            counts["route"] += 1
            if cur not in ("admitted", "requeued"):
                invalid.append(
                    f"req {req}: route from state {cur!r} "
                    "(not licensed by admit/requeue)"
                )
            state[req] = "routed"
        elif ev == "requeue":
            counts["requeue"] += 1
            if cur != "routed":
                invalid.append(f"req {req}: requeue from state {cur!r}")
            state[req] = "requeued"
        elif ev in _TERMINAL:
            counts[ev] += 1
            terminals[req] = terminals.get(req, 0) + 1
            if ev == "shed" and cur is None:
                pass  # refused at the front door — standalone terminal
            elif cur in _TERMINAL or cur == "terminal":
                pass  # counted via terminals (duplicated) below
            elif ev == "done" and cur != "routed":
                invalid.append(f"req {req}: done from state {cur!r}")
            elif ev == "error" and cur not in ("routed", "admitted",
                                               "requeued"):
                invalid.append(f"req {req}: error from state {cur!r}")
            state[req] = "terminal"
        else:
            invalid.append(f"seq {e.get('seq')}: unknown event {ev!r}")

    dropped = tuple(sorted(
        req for req, st in state.items() if st != "terminal"
    ))
    duplicated = tuple(sorted(
        req for req, n in terminals.items() if n > 1
    ))
    return JournalReplay(
        n_events=len(events),
        n_admitted=counts["admit"],
        n_done=counts["done"],
        n_error=counts["error"],
        n_shed=counts["shed"],
        n_routes=counts["route"],
        n_requeues=counts["requeue"],
        marks=tuple(marks),
        dropped=dropped,
        duplicated=duplicated,
        invalid=tuple(invalid),
    )
