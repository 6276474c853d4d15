"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Libraries go into the build directory (``_build/`` beside this file, listed
in ``.gitignore``; ``FMRP_CUDA_BUILD_DIR`` moves it), named by a hash of the
source and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing is built when this module is imported: the first kernel
launch builds what it needs, and ``build_kernels()`` builds every kernel at
once, one ``nvcc`` per source, all started together.

With a registry armed (``FMRP_REGISTRY_DIR``, ``registry.executables``) a
library missing from the build directory is first fetched from the
registry's executable plane and loaded in place; only a miss starts nvcc,
and a fresh build is stored into the registry for the next process.
``NVCC_RUNS`` counts the nvcc builds this process started.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNEL_SOURCES", "build_dir", "build_kernels", "kernel_function",
           "library_path", "publish_libraries"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
BUILD_DIR_ENV = "FMRP_CUDA_BUILD_DIR"
KERNEL_SOURCES = {"rolling": "rolling.cu", "gram": "gram.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: nvcc builds started by this process
NVCC_RUNS = 0

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}
#: name → (payload path, entry meta) of libraries the registry answered
_FETCHED: Dict[str, tuple] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (neither on PATH nor under CUDA_HOME); the CUDA "
        "kernels cannot be built"
    )


def build_dir() -> Path:
    """The build directory: ``FMRP_CUDA_BUILD_DIR`` when set, else
    ``BUILD_DIR``."""
    raw = os.environ.get(BUILD_DIR_ENV, "").strip()
    return Path(raw) if raw else BUILD_DIR


def _signature(name: str) -> str:
    from fm_returnprediction_tpu_torch.registry.executables import library_signature

    return library_signature((CSRC / KERNEL_SOURCES[name]).read_bytes(), NVCC_FLAGS)


def library_path(name: str) -> Path:
    """Where kernel ``name``'s shared library lives once built."""
    return build_dir() / f"lib{name}_{_signature(name)[:16]}.so"


def _fetch(name: str) -> bool:
    """Ask the armed registry for the library (no-op without one); a hit
    is remembered for ``_library`` to load and recorded in the cost
    ledger."""
    from fm_returnprediction_tpu_torch.registry import executables
    from fm_returnprediction_tpu_torch.telemetry import record_program

    start = time.perf_counter()
    signature = _signature(name)
    found = executables.fetch_library(name, signature)
    if found is None:
        return False
    _FETCHED[name] = found
    record_program(executables.PROGRAM, f"{name}:{signature[:16]}",
                   time.perf_counter() - start, backend="cuda",
                   provenance="fetched", saved_s=found[1].get("compile_s"))
    return True


def _store(name: str, seconds: float) -> None:
    from fm_returnprediction_tpu_torch.registry import executables
    from fm_returnprediction_tpu_torch.telemetry import record_program

    signature = _signature(name)
    record_program(executables.PROGRAM, f"{name}:{signature[:16]}", seconds,
                   backend="cuda", provenance="built")
    executables.store_library(name, signature, library_path(name), compile_s=seconds)


def build_kernels(names: Optional[Iterable[str]] = None,
                  ptxas_verbose: bool = False, fetch: bool = True) -> Dict[str, float]:
    """Make the named kernels (default: all) loadable: a library already
    built is reused, one in the armed registry is fetched, and the rest are
    compiled, one ``nvcc`` process per source, all running at once (and
    stored into the registry). Returns the seconds each build took (0.0 for
    one reused or fetched); raises with the compiler's output if any build
    fails. ``fetch=False`` (and ``ptxas_verbose``, whose report needs a
    build) skips the registry."""
    global NVCC_RUNS
    names = list(KERNEL_SOURCES) if names is None else list(names)
    target_dir = build_dir()
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists() or name in _LIBS or (
                fetch and not ptxas_verbose and _fetch(name)):
            seconds[name] = 0.0
            continue
        target_dir.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc or _nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS]
        if ptxas_verbose:
            cmd.append("-Xptxas=-v")
        cmd += ["-o", str(tmp), str(CSRC / KERNEL_SOURCES[name])]
        NVCC_RUNS += 1
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, target, time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, target, start) in procs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} ({proc.returncode}):\n{output}")
            continue
        if ptxas_verbose and output:
            print(f"[nvcc {name}]\n{output}", flush=True)
        os.replace(tmp, target)
        _store(name, seconds[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def publish_libraries(registry=None) -> Dict[str, Path]:
    """Store every library this process built and loaded into the armed
    registry's executable plane, unless the registry holds it already (the
    ``registry_publish`` stage: a library built before the registry was
    armed reaches it too). Returns the entry directory per kernel."""
    from fm_returnprediction_tpu_torch.registry import executables
    from fm_returnprediction_tpu_torch.registry.store import active_registry

    registry = registry or active_registry()
    out: Dict[str, Path] = {}
    if registry is None:
        return out
    for name in sorted(_LIBS):
        signature = _signature(name)
        entry = registry.executable_dir(executables.executable_key(name, signature))
        if registry.read_meta(entry) is None and library_path(name).exists():
            entry = executables.store_library(name, signature, library_path(name),
                                              registry=registry)
        if entry is not None and registry.read_meta(entry) is not None:
            out[name] = entry
    return out


def _library(name: str) -> ctypes.CDLL:
    from fm_returnprediction_tpu_torch.registry import executables

    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists() and name not in _FETCHED:
                build_kernels([name])
            if not path.exists():
                try:
                    lib = ctypes.CDLL(str(_FETCHED[name][0]))
                except OSError:
                    # a fetched library that will not load is a miss
                    executables.note_miss(name, "load failed")
                    del _FETCHED[name]
                    build_kernels([name], fetch=False)
            if lib is None:
                lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def kernel_function(name: str, symbol: str, argtypes,
                    restype=ctypes.c_int) -> object:
    """The C entry ``symbol`` of kernel library ``name``, with its argument
    and result types declared (built and loaded on first use)."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[key] = fn
    return fn


def check_status(name: str, status: int) -> None:
    """Raise if a kernel entry returned a non-zero status (the launch was
    refused or its arguments were not ones the kernel takes)."""
    if status != 0:
        describe = kernel_function(
            name, f"{name}_error_string", [ctypes.c_int], ctypes.c_char_p
        )
        raise RuntimeError(
            f"{name} kernel launch failed ({status}): "
            f"{describe(status).decode(errors='replace')}"
        )
