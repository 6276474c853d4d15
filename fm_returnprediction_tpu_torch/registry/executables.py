"""Executable plane: the port's compiled kernel libraries, fetched before
they are built.

The reference stores serialized XLA executables here. Eager torch has no
counterpart for them, and a CUDA graph cannot be serialized, so what the
port keeps in this plane is its only compiled device code: the nvcc
libraries ``cuda_build`` builds from ``csrc/*.cu`` (one shared library
per source). ``cuda_build.build_kernels`` asks the armed registry for a
library before it starts nvcc, and stores what it built afterwards; a
fetched library that loads is launched exactly like a built one.

Key. An entry is addressed by a digest over:

- the kernel's name and its SIGNATURE: the sha256 of the source and of
  ``cuda_build.NVCC_FLAGS`` (the counterpart of the reference's code
  salt: any edit of the source or the flags is another entry);
- the ENVIRONMENT the binary is only valid under: the nvcc release, the
  card's name and compute capability, and the torch and CUDA versions
  (:func:`environment_key`; the counterpart of the reference's backend,
  device kind, jax/jaxlib and x64 fields).

Payload. ``payload.so``, loaded in place with ``ctypes`` once its
manifest verifies deep (the registry is a trusted local directory, the
same trust as the build directory it stands in for). Nothing is copied
into the build directory, so a fetch leaves the build cache as it was
and ``telemetry.perf.recompile_watch`` sees no growth.

Misses. An absent entry, a torn meta, a manifest mismatch, environment
skew or a library that will not load is a MISS: counted in
``fmrp_registry_misses_total{plane="executables"}`` with its reason,
and the library is then built fresh from the repo's sources (the only
thing a miss falls back to). Hits are ``cuda_kernel`` records of
provenance ``fetched`` in the cost ledger, builds of provenance
``built``. Nothing here raises into a build.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

from fm_returnprediction_tpu_torch.registry import integrity
from fm_returnprediction_tpu_torch.registry.store import Registry, active_registry

__all__ = [
    "PROGRAM",
    "environment_key",
    "executable_key",
    "fetch_library",
    "library_signature",
    "note_miss",
    "store_library",
]

PAYLOAD_FILE = "payload.so"
#: the cost-ledger and registry program name of a kernel library
PROGRAM = "cuda_kernel"

_ENV_LOCK = threading.Lock()
_ENV: Optional[dict] = None


def _nvcc_release() -> str:
    """The nvcc release, read from the toolkit's ``version.json`` beside
    ``bin/nvcc`` (no process is started); ``nvcc --version`` only when the
    toolkit has no such file; ``unavailable`` without nvcc."""
    from fm_returnprediction_tpu_torch import cuda_build

    try:
        nvcc = Path(cuda_build._nvcc()).resolve()
    except RuntimeError:
        return "unavailable"
    try:
        doc = json.loads((nvcc.parent.parent / "version.json").read_text())
        return str(doc["cuda_nvcc"]["version"])
    except (OSError, ValueError, KeyError, TypeError):
        pass
    try:
        out = subprocess.run([str(nvcc), "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    found = re.search(r"release ([\d.]+), V([\d.]+)", out)
    return found.group(2) if found else "unknown"


def environment_key() -> dict:
    """The fields a kernel library is only valid under, memoized per
    process. On a machine without a card the device fields read
    ``none``, so two such processes still agree."""
    global _ENV
    with _ENV_LOCK:
        if _ENV is None:
            import torch

            if torch.cuda.is_available():
                major, minor = torch.cuda.get_device_capability(0)
                device_kind = torch.cuda.get_device_name(0)
                capability = f"sm_{major}{minor}"
            else:
                device_kind, capability = "none", "none"
            _ENV = {
                "backend": "cuda",
                "device_kind": device_kind,
                "compute_capability": capability,
                "nvcc": _nvcc_release(),
                "torch": torch.__version__,
                "cuda": str(torch.version.cuda),
            }
        return dict(_ENV)


def library_signature(source: bytes, flags) -> str:
    """The source-and-flags half of an entry's address."""
    return hashlib.sha256(source + " ".join(flags).encode()).hexdigest()


def executable_key(name: str, signature: str) -> str:
    """Content address of one library entry (the entry directory name)."""
    payload = json.dumps({"program": f"{PROGRAM}:{name}", "signature": signature,
                          "env": environment_key()}, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def note_miss(name: str, reason: str) -> None:
    """Count one executable-plane miss with its reason."""
    from fm_returnprediction_tpu_torch.telemetry import metrics as _metrics

    _metrics.registry().counter(
        "fmrp_registry_misses_total",
        help="registry fetches that found no usable entry, by plane and reason",
        plane="executables", program=f"{PROGRAM}:{name}", reason=reason,
    ).inc()


def store_library(name: str, signature: str, path, compile_s: Optional[float] = None,
                  registry: Optional[Registry] = None) -> Optional[Path]:
    """Publish a built library; returns the entry dir, or None when the
    registry is off or the write failed (warned: the caller already holds
    a working library, persistence is an accelerant)."""
    registry = registry or active_registry()
    if registry is None:
        return None
    try:
        meta = {
            "kind": "executable",
            "program": f"{PROGRAM}:{name}",
            "signature": signature[:16],
            "source_sha256": signature,
            "bucket": None,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            # the nvcc seconds this entry cost; every later fetch reports
            # them as its saved_s
            "compile_s": round(compile_s, 6) if compile_s is not None else None,
            **environment_key(),
        }
        entry = registry.executable_dir(executable_key(name, signature))
        registry.write_entry(entry, {PAYLOAD_FILE: Path(path).read_bytes()}, meta)
        return entry
    except Exception as exc:  # noqa: BLE001 — see docstring
        warnings.warn(f"registry store failed for kernel {name!r} ({exc!r}); "
                      "the built library is unaffected", stacklevel=2)
        return None


def fetch_library(name: str, signature: str,
                  registry: Optional[Registry] = None) -> Optional[tuple]:
    """Fetch one library: key lookup → meta → environment check → deep
    manifest verification. Returns the verified payload's path and the
    entry meta, or None on a miss (counted with its reason; the caller
    builds). A corrupt entry is dropped, unless a concurrent writer
    re-published it in the meantime. The caller loads the path and counts
    a failed load as a miss too (:func:`note_miss`)."""
    registry = registry or active_registry()
    if registry is None:
        return None
    entry = registry.executable_dir(executable_key(name, signature))
    meta = registry.read_meta(entry)
    if meta is None:
        note_miss(name, "absent" if not entry.exists() else "unreadable meta")
        return None
    if any(meta.get(k) != v for k, v in environment_key().items()):
        # the address already embeds the environment, so this fires only
        # for tampered or colliding meta
        note_miss(name, "environment skew")
        return None
    try:
        integrity.verify_manifest(entry, meta.get("manifest", {}), deep=True)
    except integrity.CorruptArtifactError:
        if registry.read_meta(entry) == meta:
            registry.drop(entry)
        note_miss(name, "manifest mismatch")
        return None
    return entry / PAYLOAD_FILE, meta

