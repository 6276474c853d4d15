"""The port offers every public name of the JAX package, at the same
module path.

Both packages are parsed with ``ast`` and neither is imported. For each
module of ``fm_returnprediction_tpu/`` (except the two Pallas modules,
whose kernels are ``csrc/``), the port's module of the same path must
define, import or list in ``__all__``:

- each name in the JAX module's ``__all__``;
- each public top-level ``def``, ``class`` and constant;
- each public method of a public class (defined in the class, in a base
  class of the same module, or in the module the port imports the class
  from).

Each ``FMRP_*`` knob the JAX package names as a string must be a string
in the port, and each ``--flag`` of an ``argparse`` parser must be added
by the port's module of the same path. A name that the port leaves out by
design is in ``ALLOWED`` with the mechanism that makes it JAX-only, or the
port's counterpart; an entry the port does define, or the JAX package no
longer has, is stale and fails.
"""

import ast
import functools
import re
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "fm_returnprediction_tpu"
PORT = REPO / "fm_returnprediction_tpu_torch"
PALLAS = ("ops/pallas_kernels.py", "ops/gram_pallas.py")

_ROUTE = ("a route knob: the port has no route knob and no fallback; the kernel "
          "runs on a CUDA tensor and its plain version on a CPU tensor")
_TRACE = "a jit trace counter: eager torch traces nothing"
_XLA_EXE = ("the XLA executable plane: the port's executables are the nvcc "
            "libraries (registry.executables.store_library / fetch_library)")
_AOT = ("XLA's AOT compile and cost analysis: the port builds no program ahead of "
        "use but CUDA graphs and nvcc libraries (telemetry.perf.record_program)")

#: "module:name", "knob:NAME" or "flag:module:--flag" → why the port has none
ALLOWED = {
    "ops/rolling.py:ROLLING_ROUTES": _ROUTE,
    "ops/rolling.py:resolve_rolling_route": _ROUTE,
    "specgrid/grams.py:GRAM_ROUTES": _ROUTE,
    "specgrid/grams.py:resolve_gram_route": _ROUTE,
    "specgrid/boot.py:BOOT_ROUTES": _ROUTE,
    "specgrid/boot.py:resolve_boot_route": _ROUTE,
    "specgrid/boot.py:fm_aggregate_np": "the host aggregation of the `host` boot route: "
                                        + _ROUTE,
    "knob:FMRP_PALLAS": _ROUTE,
    "knob:FMRP_ROLLING_ROUTE": _ROUTE,
    "knob:FMRP_GRAM_ROUTE": _ROUTE,
    "knob:FMRP_BOOT_ROUTE": _ROUTE,
    "parallel/__init__.py:shard_map": "jax.shard_map: the port's sharded programs are "
                                      "stages with explicit collectives (parallel.mesh)",
    "parallel/mesh.py:shard_map": "jax.shard_map: the port's sharded programs are "
                                  "stages with explicit collectives (parallel.mesh)",
    "settings.py:enable_compilation_cache": "XLA's persistent compilation cache: the port "
                                            "compiles only the nvcc libraries, cached in "
                                            "cuda_build's build directory",
    "telemetry/__init__.py:jax_cache_stats": "XLA's compilation-cache counters: the port's "
                                             "is telemetry.perf.recompile_watch",
    "telemetry/metrics.py:jax_cache_stats": "XLA's compilation-cache counters: the port's "
                                            "is telemetry.perf.recompile_watch",
    "telemetry/__init__.py:record_trace": _TRACE,
    "telemetry/metrics.py:record_trace": _TRACE,
    "telemetry/__init__.py:record_compiled": _AOT,
    "telemetry/perf.py:record_compiled": _AOT,
    "telemetry/__init__.py:timed_aot_compile": _AOT,
    "telemetry/perf.py:timed_aot_compile": _AOT,
    "telemetry/perf.py:arg_signature": "the key of XLA's AOT cache: " + _AOT,
    "specgrid/__init__.py:program_trace_counts": _TRACE,
    "specgrid/solve.py:program_trace_counts": _TRACE,
    "specgrid/solve.py:PROGRAM_TRACES": _TRACE,
    "ops/ols.py:TRACES": _TRACE,
    "panel/characteristics.py:TRACES": _TRACE,
    "utils/timing.py:stage_sync": "blocks on async jax dispatch under FMRP_SYNC_STAGES: "
                                  "the port's StageTimer synchronizes the device at every "
                                  "stage; its counterpart is telemetry.spans.device_sync",
    "registry/__init__.py:code_salt": _XLA_EXE,
    "registry/__init__.py:load_executable": _XLA_EXE,
    "registry/__init__.py:store_executable": _XLA_EXE,
    "registry/executables.py:code_salt": _XLA_EXE,
    "registry/executables.py:load_executable": _XLA_EXE,
    "registry/executables.py:store_executable": _XLA_EXE,
    "registry/executables.py:LoadedExecutable": _XLA_EXE,
    "specgrid/multiproc.py:multiproc_grid_parts": "the jitted per-worker program parts "
                                                  "of the reference: the port's workers "
                                                  "run K2 (specgrid.mp_worker)",
    "flag:pipeline.py:--backend": "a JAX platform name: replaced by --device {cuda,cpu}",
    "flag:taskgraph/__main__.py:--backend": "a JAX platform name: replaced by --device "
                                            "{cuda,cpu}",
}


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _modules(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                  if "_build" not in p.parts)


JAX_MODULES = [m for m in _modules(JAX) if m not in PALLAS]


def _dunder_all(body) -> list:
    for node in body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            try:
                return list(ast.literal_eval(node.value))
            except ValueError:
                return []
    return []


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_surface(rel: str) -> set:
    """The JAX module's public names: ``__all__``, public top-level defs,
    classes and constants, and ``Class.method`` for public methods."""
    body = _tree(JAX / rel).body
    names = set(_dunder_all(body))
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if _public(node.name):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{m.name}" for m in node.body
                              if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                              and _public(m.name)}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)
                      and _public(t.id)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if _public(node.target.id):
                names.add(node.target.id)
    return names


def _bindings(body, out: dict) -> None:
    """Top-level bindings (also those inside top-level ``if``/``try``):
    name → the defining node, or ("import", module, name) for an import."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for leaf in ast.walk(target):
                    if isinstance(leaf, ast.Name):
                        out[leaf.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                out[alias.asname or alias.name] = ("import", node.module, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = ("import", None, None)
        elif isinstance(node, ast.If):
            _bindings(node.body + node.orelse, out)
        elif isinstance(node, ast.Try):
            _bindings(node.body + node.orelse + node.finalbody
                      + [s for h in node.handlers for s in h.body], out)


@functools.lru_cache(maxsize=None)
def _port_bindings(rel: str, root: Path) -> dict:
    out: dict = {}
    path = root / rel
    if path.exists():
        _bindings(_tree(path).body, out)
    return out


def _port_module_of(module: str, root: Path):
    """The path under ``root`` of a ``fm_returnprediction_tpu_torch.…``
    module, or None."""
    if not module or not module.startswith("fm_returnprediction_tpu_torch."):
        return None
    parts = module.split(".")[1:]
    for rel in ("/".join(parts) + ".py", "/".join(parts) + "/__init__.py"):
        if (root / rel).exists():
            return rel
    return None


def _class_methods(rel: str, cls: str, root: Path, seen=()) -> set:
    """Methods of class ``cls`` as the port's module ``rel`` binds it: its
    own, those of bases in the same module, or those of the module it is
    imported from."""
    if (rel, cls) in seen:
        return set()
    seen = seen + ((rel, cls),)
    bound = _port_bindings(rel, root).get(cls)
    if isinstance(bound, tuple):
        src = _port_module_of(bound[1], root)
        return _class_methods(src, bound[2], root, seen) if src else set()
    if not isinstance(bound, ast.ClassDef):
        return set()
    methods = set()
    for node in bound.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods.add(node.name)
        elif isinstance(node, ast.Assign):
            methods |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    for base in bound.bases:
        if isinstance(base, ast.Name):
            methods |= _class_methods(rel, base.id, root, seen)
    return methods


def port_has(rel: str, name: str, root: Path = PORT) -> bool:
    if "." in name:
        cls, method = name.split(".", 1)
        return method in _class_methods(rel, cls, root)
    return name in _port_bindings(rel, root) or (
        (root / rel).exists() and name in _dunder_all(_tree(root / rel).body))


def _missing(rel: str, root: Path = PORT) -> list:
    return sorted(n for n in jax_surface(rel)
                  if not port_has(rel, n, root) and f"{rel}:{n}" not in ALLOWED)


def _strings(root: Path, pattern: str) -> set:
    rx = re.compile(pattern)
    out = set()
    for rel in _modules(root):
        for node in ast.walk(_tree(root / rel)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and rx.fullmatch(node.value):
                out.add(node.value)
    return out


def _flags(path: Path) -> set:
    if not path.exists():
        return set()
    out = set()
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "add_argument":
            out |= {a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("--")}
    return out


def test_every_jax_module_is_scanned():
    assert len(JAX_MODULES) > 120
    assert "ops/daily_chunked.py" in JAX_MODULES and "ops/pallas_kernels.py" not in JAX_MODULES


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_defines_every_public_name(rel):
    assert (PORT / rel).exists(), f"the port has no module {rel}"
    missing = _missing(rel)
    assert not missing, f"{rel}: the port lacks {missing}"


def test_port_reads_every_knob():
    port = _strings(PORT, r"FMRP_[A-Z0-9_]+")
    missing = sorted(k for k in _strings(JAX, r"FMRP_[A-Z0-9_]+")
                     if k not in port and f"knob:{k}" not in ALLOWED)
    assert not missing, f"knobs the port does not read: {missing}"


@pytest.mark.parametrize("rel", sorted(m for m in JAX_MODULES if _flags(JAX / m)))
def test_port_parsers_take_every_flag(rel):
    port = _flags(PORT / rel)
    missing = sorted(f for f in _flags(JAX / rel)
                     if f not in port and f"flag:{rel}:{f}" not in ALLOWED)
    assert not missing, f"{rel}: flags the port's parser lacks: {missing}"


def test_allowlist_has_no_stale_entry():
    jax_knobs = _strings(JAX, r"FMRP_[A-Z0-9_]+")
    port_knobs = _strings(PORT, r"FMRP_[A-Z0-9_]+")
    stale = []
    for key, reason in ALLOWED.items():
        assert reason, key
        kind, _, rest = key.partition(":")
        if kind == "knob":
            if rest not in jax_knobs or rest in port_knobs:
                stale.append(key)
        elif kind == "flag":
            rel, _, flag = rest.partition(":")
            if flag not in _flags(JAX / rel) or flag in _flags(PORT / rel):
                stale.append(key)
        elif rest not in jax_surface(kind) or port_has(kind, rest):
            stale.append(key)
    assert not stale, f"allowlist entries the port defines or the reference lacks: {stale}"


@pytest.mark.parametrize("rel, name, old, new", [
    ("panel/daily.py", "build_daily_panel", "def build_daily_panel(", "def _gone("),
    ("specgrid/specs.py", "SpecGrid.universe_names", "def universe_names(", "def _gone("),
    ("ops/__init__.py", "winsorize_cs", "masked_quantile, winsorize_cs", "masked_quantile"),
])
def test_scan_sees_a_deleted_name(tmp_path, rel, name, old, new):
    """The check fails on a name the port lacks: a copy of one port module
    with one name taken out (from its ``__all__`` too)."""
    copy = tmp_path / "port"
    (copy / rel).parent.mkdir(parents=True)
    text = (PORT / rel).read_text()
    assert old in text
    text = text.replace(old, new).replace(f'"{name}", ', "").replace(f'"{name}",\n', "")
    (copy / rel).write_text(text)
    assert _missing(rel) == []
    assert _missing(rel, root=copy) == [name]
