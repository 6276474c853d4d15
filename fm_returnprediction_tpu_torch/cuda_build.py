"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Libraries go into ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of the source and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing is built when this module is imported: the
first kernel launch builds what it needs, and ``build_kernels()`` builds
every kernel at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNEL_SOURCES", "build_kernels", "kernel_function", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = {"rolling": "rolling.cu", "gram": "gram.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (neither on PATH nor under CUDA_HOME); the CUDA "
        "kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where kernel ``name``'s shared library lives once built."""
    source = CSRC / KERNEL_SOURCES[name]
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_kernels(names: Optional[Iterable[str]] = None,
                  ptxas_verbose: bool = False) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all running at once. Returns the seconds
    each build took (0.0 for one already built); raises with the compiler's
    output if any build fails."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS]
        if ptxas_verbose:
            cmd.append("-Xptxas=-v")
        cmd += ["-o", str(tmp), str(CSRC / KERNEL_SOURCES[name])]
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
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def _library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_kernels([name])
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
