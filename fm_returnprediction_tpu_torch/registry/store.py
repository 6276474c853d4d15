"""The versioned, content-addressed registry root.

One directory tree (``FMRP_REGISTRY_DIR``) holds everything a fresh
process needs to reach quoting-ready without rebuilding:

- ``executables/<key>/``  — the compiled device binaries of the port, the
  nvcc kernel libraries (:mod:`.executables`): ``payload.so`` +
  ``meta.json``;
- ``artifacts/<name>/<fingerprint>/`` — schema-versioned artifacts
  (:mod:`.artifacts`): payload files + ``meta.json``;
- ``prepared/<slot>/``    — the prepared-inputs panel checkpoint slots
  (``data.prepared`` writes its own columnar layout there when the
  registry is armed).

Every entry directory follows the same crash-consistency contract as the
prepared checkpoint: payloads first, ``meta.json`` LAST (tmp +
``os.replace``), carrying a sha256+size manifest over the payloads from
:mod:`.integrity` — a torn write is indistinguishable from an absent
entry, and bit-rot surfaces as the typed ``CorruptArtifactError`` that
every consumer degrades on (a rebuild), never a crash.

The layout, the meta keys and ``SCHEMA_VERSION`` are the reference
package's, so a registry either package writes lists and verifies in the
other (only the executable plane's payloads are each package's own).

The registry is OFF unless ``FMRP_REGISTRY_DIR`` is set (or a CLI passes
``--registry-dir``, which sets it for the process): an unarmed process
behaves exactly as before this layer existed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional, Union

from fm_returnprediction_tpu_torch.registry import integrity

__all__ = [
    "REGISTRY_ENV",
    "SCHEMA_VERSION",
    "registry_dir",
    "active_registry",
    "using_registry",
    "Registry",
]

REGISTRY_ENV = "FMRP_REGISTRY_DIR"
#: bump when the on-disk entry layout changes — an old tree must read as
#: absent to a new process, not as a half-compatible hit
SCHEMA_VERSION = 1

META_FILE = "meta.json"
LOCK_FILE = ".publish.lock"
_EXE_DIRNAME = "executables"
_ART_DIRNAME = "artifacts"
_PREPARED_DIRNAME = "prepared"


class _publish_lock:
    """Advisory, blocking, cross-process exclusive lock on one entry
    directory (``fcntl.flock``; auto-released on close AND on process
    death). The lock file is a SIBLING of the entry
    (``.<entry>.publish.lock``), not inside it: ``drop()``/``gc()``
    rmtree entry dirs, and an in-dir lock would let delete+recreate mint
    a fresh inode while a publisher still holds the old one — two
    writers holding "the" lock at once. A sibling inode survives entry
    deletion, so publishers and maintenance serialize on one file.
    Dot-prefixed and a plain file, so entry scans (directories) never
    see it."""

    def __init__(self, entry_dir: Path):
        entry_dir = Path(entry_dir)
        self._path = entry_dir.parent / f".{entry_dir.name}{LOCK_FILE}"
        self._fh = None

    def __enter__(self) -> "_publish_lock":
        try:
            import fcntl
        except ImportError:  # non-POSIX: historical unlocked protocol
            return self
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self._path, "a+")
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc) -> None:
        if self._fh is not None:
            try:
                import fcntl

                fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            finally:
                self._fh.close()
                self._fh = None


def registry_dir() -> Optional[Path]:
    """The armed registry root, or None. Resolved LIVE from the
    environment (the repo-wide knob discipline: tests and benches flip
    routes per call via ``monkeypatch.setenv``)."""
    raw = os.environ.get(REGISTRY_ENV, "").strip()
    return Path(raw) if raw else None


_CACHE_LOCK = threading.Lock()
_CACHED: Optional[tuple] = None  # (root_str, Registry)


def active_registry() -> Optional["Registry"]:
    """The process's :class:`Registry` for the armed root, or None when
    the registry is off. One instance per root (cheap to re-resolve, and
    a changed env var mid-process — tests — picks up the new root)."""
    global _CACHED
    root = registry_dir()
    if root is None:
        return None
    key = str(root)
    with _CACHE_LOCK:
        if _CACHED is not None and _CACHED[0] == key:
            return _CACHED[1]
        reg = Registry(root)
        _CACHED = (key, reg)
        return reg


class using_registry:
    """Context manager arming ``FMRP_REGISTRY_DIR`` for a block (the
    ``run_pipeline(registry_dir=...)`` plumbing — env-based so every
    live-resolving consumer in the process sees the same root)."""

    def __init__(self, root: Optional[Union[Path, str]]):
        self.root = root
        self._prev: Optional[str] = None

    def __enter__(self) -> Optional["Registry"]:
        if self.root is None:
            return active_registry()
        self._prev = os.environ.get(REGISTRY_ENV)
        os.environ[REGISTRY_ENV] = str(self.root)
        return active_registry()

    def __exit__(self, *exc) -> None:
        if self.root is None:
            return
        if self._prev is None:
            os.environ.pop(REGISTRY_ENV, None)
        else:
            os.environ[REGISTRY_ENV] = self._prev


class Registry:
    """Filesystem-backed registry over one root directory.

    Entry directories are written by :meth:`write_entry` (payloads,
    then manifest-bearing meta — atomic publish) and read by
    :meth:`read_meta` / :meth:`verify_entry`. The maintenance surface
    (:meth:`ls` / :meth:`verify` / :meth:`gc`) backs the
    ``python -m fm_returnprediction_tpu_torch.registry`` CLI.
    """

    def __init__(self, root: Union[Path, str]):
        self.root = Path(root)

    # -- layout ------------------------------------------------------------

    @property
    def executables_root(self) -> Path:
        return self.root / _EXE_DIRNAME

    @property
    def artifacts_root(self) -> Path:
        return self.root / _ART_DIRNAME

    def prepared_root(self, slot: str) -> Path:
        """The prepared-inputs checkpoint slot for one raw directory
        (``data.prepared`` owns the layout inside)."""
        return self.root / _PREPARED_DIRNAME / slot

    def executable_dir(self, key: str) -> Path:
        return self.executables_root / key

    def artifact_dir(self, name: str, fingerprint: str) -> Path:
        return self.artifacts_root / name / fingerprint

    # -- entry IO ----------------------------------------------------------

    def write_entry(self, entry_dir: Path, payloads: Dict[str, bytes],
                    meta: dict) -> Path:
        """Publish one entry atomically: payload files, then ``meta.json``
        (tmp + rename) carrying the integrity manifest. An existing entry
        is invalidated first (meta removed) so a crash mid-rewrite leaves
        an absent entry, never a stale-manifest one."""
        def emit(entry: Path) -> list:
            names = []
            for name, blob in payloads.items():
                path = entry / name
                tmp = entry / f".{name}.tmp-{os.getpid()}"
                try:
                    tmp.write_bytes(blob)
                    os.replace(tmp, path)
                finally:
                    tmp.unlink(missing_ok=True)
                names.append(path)
            return names

        return self._publish_entry(entry_dir, list(payloads), emit, meta)

    def write_entry_from_paths(self, entry_dir: Path, paths, meta: dict
                               ) -> Path:
        """:meth:`write_entry` for payloads that already exist as files —
        copied in (streaming, no whole-file round-trip through memory)
        under the same atomic-publish protocol."""
        paths = [Path(p) for p in paths]

        def emit(entry: Path) -> list:
            names = []
            for src in paths:
                dst = entry / src.name
                tmp = entry / f".{src.name}.tmp-{os.getpid()}"
                try:
                    shutil.copyfile(src, tmp)
                    os.replace(tmp, dst)
                finally:
                    tmp.unlink(missing_ok=True)
                names.append(dst)
            return names

        return self._publish_entry(
            entry_dir, [p.name for p in paths], emit, meta
        )

    def _publish_entry(self, entry_dir: Path, payload_names, emit,
                       meta: dict) -> Path:
        """The ONE crash-consistency protocol both entry writers share:
        reserved-name guard, advisory cross-PROCESS publish lock, meta
        invalidation BEFORE payloads, per-file tmp+rename,
        manifest-bearing meta LAST.

        The lock (``fcntl.flock`` on the entry's sibling
        ``.<entry>.publish.lock``) serializes concurrent publishers: N
        processes warming the same
        registry simultaneously — the multi-process spec-grid workers,
        fleet replica spawns — would otherwise interleave their per-file
        renames and publish file A from one writer under file B's
        manifest (a half-renamed entry a reader sees as corruption).
        Readers need no lock: meta is still written last, so mid-publish
        they observe an ABSENT entry (degrade to a rebuild), never
        a torn one. Advisory flocks release on process death, so a
        crashed publisher cannot wedge the registry; on platforms
        without ``fcntl`` the lock degrades to the historical unlocked
        protocol."""
        if META_FILE in payload_names:
            raise ValueError(f"payload name {META_FILE!r} is reserved")
        entry_dir = Path(entry_dir)
        entry_dir.mkdir(parents=True, exist_ok=True)
        with _publish_lock(entry_dir):
            meta_path = entry_dir / META_FILE
            meta_path.unlink(missing_ok=True)  # invalidate before payloads
            written = emit(entry_dir)
            meta = dict(meta)
            meta["schema"] = SCHEMA_VERSION
            meta["manifest"] = integrity.build_manifest(written)
            tmp = entry_dir / f".{META_FILE}.tmp-{os.getpid()}"
            try:
                tmp.write_text(json.dumps(meta, sort_keys=True))
                os.replace(tmp, meta_path)
            finally:
                tmp.unlink(missing_ok=True)
        return entry_dir

    def read_meta(self, entry_dir: Path) -> Optional[dict]:
        """The entry's meta, or None when absent/torn/schema-skewed —
        absence and unreadability are the same answer (rebuild)."""
        try:
            meta = json.loads((Path(entry_dir) / META_FILE).read_text())
        except (OSError, ValueError):
            return None
        if meta.get("schema") != SCHEMA_VERSION:
            return None
        return meta

    def verify_entry(self, entry_dir: Path, deep: bool = False) -> dict:
        """Meta + manifest verification for one entry; raises the typed
        ``CorruptArtifactError`` on any mismatch."""
        meta = self.read_meta(entry_dir)
        if meta is None:
            raise integrity.CorruptArtifactError(
                f"registry entry {entry_dir} has no readable meta"
            )
        integrity.verify_manifest(entry_dir, meta.get("manifest", {}),
                                  deep=deep)
        return meta

    # -- maintenance surface (the __main__ CLI) ----------------------------

    def _entry_dirs(self) -> List[Path]:
        out: List[Path] = []
        if self.executables_root.is_dir():
            out.extend(sorted(
                p for p in self.executables_root.iterdir() if p.is_dir()
            ))
        if self.artifacts_root.is_dir():
            for name_dir in sorted(self.artifacts_root.iterdir()):
                if name_dir.is_dir():
                    out.extend(sorted(
                        p for p in name_dir.iterdir() if p.is_dir()
                    ))
        return out

    def _prepared_slots(self) -> List[Path]:
        root = self.root / _PREPARED_DIRNAME
        if not root.is_dir():
            return []
        return sorted(p for p in root.iterdir() if p.is_dir())

    def _prepared_meta(self, slot: Path) -> Optional[dict]:
        """A prepared slot's meta.json (``data.prepared`` owns the format
        — no registry schema field, but the SAME manifest shape)."""
        try:
            meta = json.loads((slot / "meta.json").read_text())
        except (OSError, ValueError):
            return None
        return meta if isinstance(meta.get("manifest"), dict) else None

    def ls(self) -> List[dict]:
        """One row per entry — executables, artifacts, AND prepared
        checkpoint slots: kind, key/name, payload bytes, and the salient
        meta fields (program/backend and the stack's version for
        executables)."""
        rows: List[dict] = []
        for entry in self._entry_dirs():
            meta = self.read_meta(entry)
            manifest = (meta or {}).get("manifest", {})
            size = sum(int(e.get("size", 0)) for e in manifest.values())
            kind = ("executable"
                    if entry.parent == self.executables_root else "artifact")
            row = {
                "kind": kind,
                "path": str(entry.relative_to(self.root)),
                "bytes": size,
                "readable": meta is not None,
            }
            if meta:
                for field in ("program", "signature", "name", "backend",
                              "jax", "torch", "created_at", "fingerprint"):
                    if field in meta:
                        row[field] = meta[field]
            rows.append(row)
        for slot in self._prepared_slots():
            meta = self._prepared_meta(slot)
            manifest = (meta or {}).get("manifest", {})
            rows.append({
                "kind": "prepared",
                "name": slot.name,
                "path": str(slot.relative_to(self.root)),
                "bytes": sum(
                    int(e.get("size", 0)) for e in manifest.values()
                ),
                "readable": meta is not None,
            })
        return rows

    def verify(self, deep: bool = True) -> List[dict]:
        """Verify every entry — including prepared checkpoint slots, the
        tree's largest payloads; returns one row per CORRUPT entry (empty
        list = clean tree). Never raises — the CLI reports and exits 1."""
        bad: List[dict] = []
        for entry in self._entry_dirs():
            try:
                self.verify_entry(entry, deep=deep)
            except integrity.CorruptArtifactError as exc:
                bad.append({
                    "path": str(entry.relative_to(self.root)),
                    "error": str(exc),
                })
        for slot in self._prepared_slots():
            meta = self._prepared_meta(slot)
            if meta is None:
                bad.append({
                    "path": str(slot.relative_to(self.root)),
                    "error": "prepared slot has no readable meta",
                })
                continue
            try:
                integrity.verify_manifest(slot, meta["manifest"], deep=deep)
            except integrity.CorruptArtifactError as exc:
                bad.append({
                    "path": str(slot.relative_to(self.root)),
                    "error": str(exc),
                })
        return bad

    def drop(self, entry_dir: Path) -> None:
        """Remove one entry (meta first, so a concurrent reader sees an
        absent entry rather than payload-less meta). Serialized on the
        entry's publish lock: deleting the dir out from under a
        mid-publish writer would both fail its emit and — were the lock
        inside the dir — hand the lock's identity to the next writer."""
        entry_dir = Path(entry_dir)
        with _publish_lock(entry_dir):
            (entry_dir / META_FILE).unlink(missing_ok=True)
            shutil.rmtree(entry_dir, ignore_errors=True)

    def gc(self, keep: int = 4, drop_skewed: bool = False,
           dry_run: bool = False) -> List[dict]:
        """Garbage-collect the tree; returns the dropped entries.

        Policy: per executable (program, SIGNATURE) keep the ``keep``
        newest entries — one signature per live build, so a complete
        current set (every kernel library) is never thinned by maintenance —
        per artifact *name* keep the ``keep`` newest fingerprints.
        ``drop_skewed`` additionally drops executables built under another
        stack (torch, CUDA, nvcc, compute capability); it is OPT-IN because
        skew is judged against THIS process's stack — on a shared
        registry, maintenance run from a login node or after a local
        upgrade would otherwise wipe every other stack's (perfectly live)
        libraries.
        Run it from the consumers' stack, where a skewed entry really can
        never load. Prepared checkpoint slots self-overwrite in place
        (one slot per raw dir) and are retained unless torn.
        Unreadable/torn entries are always dropped."""
        env = None
        if drop_skewed:
            # environment_key() asks nvcc and the card: only pay that when
            # the skew policy actually needs the comparison
            from fm_returnprediction_tpu_torch.registry import executables as _exe

            env = _exe.environment_key()
        dropped: List[dict] = []

        def _drop(entry: Path, why: str) -> None:
            dropped.append({
                "path": str(entry.relative_to(self.root)), "reason": why,
            })
            if not dry_run:
                self.drop(entry)

        groups: Dict[tuple, List[tuple]] = {}
        for entry in self._entry_dirs():
            meta = self.read_meta(entry)
            if meta is None:
                _drop(entry, "unreadable meta")
                continue
            if entry.parent == self.executables_root:
                if env is not None and {
                    k: meta.get(k) for k in env
                } != env:
                    _drop(entry, "environment skew")
                    continue
                # key per (program, signature): distinct signatures are
                # distinct live programs, not history of one another
                group = ("executable",
                         f"{meta.get('program', '?')}"
                         f"@{meta.get('signature', '?')}")
            else:
                group = ("artifact", entry.parent.name)
            groups.setdefault(group, []).append(
                (meta.get("created_at") or "", entry)
            )
        for group, entries in groups.items():
            entries.sort(key=lambda kv: kv[0])
            for _, entry in entries[:-keep] if keep > 0 else entries:
                _drop(entry, f"beyond keep={keep} for {group[1]}")
        for slot in self._prepared_slots():
            if self._prepared_meta(slot) is None:
                _drop(slot, "torn prepared slot")
        return dropped
