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

The same holds for the parameters of every public function, public method
and ``__init__`` that both packages define at the same module path, so a
call written for the JAX package binds alike in the port:

- each JAX parameter is a parameter of the port's function;
- the JAX function's positional parameters are the port's leading
  positional parameters, in the same order (parameters only the port has
  come after them or are keyword-only);
- a default that is a literal constant on both sides is the same.

A parameter that differs by design is in ``ALLOWED_PARAMS`` as
``"module:function:parameter"`` with the reason: a JAX parameter the port
has no counterpart of, or a port parameter that stands in its place among
the positional ones. An entry that no check needs is stale and fails.
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


_ROUTE_PARAM = ("a route parameter: the port has no route knob and no fallback; the "
                "device of the tensors decides between the kernel and its plain version")
_PRNG = ("a JAX PRNG key: the port draws from a seeded CPU generator "
         "(parallel.bootstrap), so the key's place is taken by the seed or the draws")
_SHARD_LOCAL = ("shard_map-local blocks: the port's sharded program is stages with "
                "explicit collectives, so the kernel takes the mesh and the per-shard lists")

#: "module:function:parameter" → why the parameter differs by design
ALLOWED_PARAMS = {
    **{f"{fn}:use_pallas": _ROUTE_PARAM for fn in (
        "ops/daily_chunked.py:daily_characteristics_chunked",
        "ops/daily_chunked.py:daily_characteristics_compact_chunked",
        "ops/daily_compact.py:daily_compact_strip",
        "ops/daily_compact.py:daily_compact_strip_contiguous",
        "ops/daily_kernels.py:rolling_vol_252_monthly",
        "ops/rolling.py:rolling_sum", "ops/rolling.py:rolling_mean",
        "ops/rolling.py:rolling_std")},
    **{f"{fn}:gram_route": _ROUTE_PARAM for fn in (
        "specgrid/engine.py:run_cellspace",
        "specgrid/estimators/grid.py:run_estimator_grid_weights",
        "specgrid/grambank.py:bank_key", "specgrid/grambank.py:build_bank",
        "specgrid/grambank.py:load_bank", "specgrid/scenarios.py:run_scenarios",
        "specgrid/scenarios.py:bank_for_scenarios", "specgrid/solve.py:run_spec_grid",
        "specgrid/solve.py:run_spec_grid_weights")},
    "specgrid/engine.py:run_cellspace:boot_route": _ROUTE_PARAM,
    "specgrid/scenarios.py:run_scenarios:boot_route": _ROUTE_PARAM,
    "specgrid/grams.py:contract_spec_grams:route": _ROUTE_PARAM,
    "specgrid/grams.py:contract_spec_grams:block_n": "the Pallas firm block: " + _ROUTE_PARAM,
    "specgrid/grams.py:contract_spec_grams:interpret": "Pallas interpret mode: "
                                                       + _ROUTE_PARAM,
    "parallel/bootstrap.py:bootstrap_replicate_means:keys": _PRNG,
    "parallel/bootstrap.py:bootstrap_replicate_means:starts": _PRNG,
    "parallel/bootstrap.py:block_bootstrap_se:key": _PRNG,
    "parallel/bootstrap.py:block_bootstrap_se:seed": _PRNG,
    **{f"parallel/fm_sharded.py:cs_ols_kernel:{name}": _SHARD_LOCAL
       for name in ("y_l", "x_l", "mask_l", "mesh", "y", "x", "mask")},
    "registry/executables.py:executable_key:program": (
        "an XLA program to fingerprint: the port's executables are nvcc libraries, "
        "keyed by the library's name"),
    "registry/executables.py:executable_key:name": (
        "the nvcc library's name, in the place of the reference's XLA program"),
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


# --------------------------------------------------------------- parameters


def _functions(path: Path) -> dict:
    """Public top-level functions and the public methods and ``__init__``
    of public classes: "name" or "Class.method" → the def node."""
    out = {}
    if not path.exists():
        return out
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        _public(m.name) or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = m
    return out


_NO_LITERAL = object()


def _literal(node):
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError, MemoryError, RecursionError):
        return _NO_LITERAL


def _signature(fn) -> tuple:
    """(positional names, keyword-only names, {name: literal default})
    without ``self``/``cls``."""
    a = fn.args
    positional = [p.arg for p in a.posonlyargs + a.args]
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    literals = {}
    for name, node in list(zip(positional, defaults)) + list(
            zip((p.arg for p in a.kwonlyargs), a.kw_defaults)):
        if node is not None and _literal(node) is not _NO_LITERAL:
            literals[name] = _literal(node)
    if positional[:1] in (["self"], ["cls"]):
        positional = positional[1:]
    return positional, [p.arg for p in a.kwonlyargs], literals


def _same(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float) and a != a and b != b)


def param_failures(rel: str, name: str, root: Path = PORT, allowed=None) -> list:
    """How a JAX-style call of ``rel``'s ``name`` would bind otherwise in
    the port's function: missing parameters, a positional order that
    differs, literal defaults that differ (``ALLOWED_PARAMS`` entries
    excepted)."""
    allowed = ALLOWED_PARAMS if allowed is None else allowed
    j_pos, j_kw, j_lit = _signature(_functions(JAX / rel)[name])
    p_pos, p_kw, p_lit = _signature(_functions(root / rel)[name])
    skip = {key.rsplit(":", 1)[1] for key in allowed if key.rsplit(":", 1)[0] == f"{rel}:{name}"}
    out = [f"missing {p}" for p in j_pos + j_kw if p not in p_pos + p_kw and p not in skip]
    want = [p for p in j_pos if p not in skip]
    got = [p for p in p_pos if p not in skip][:len(want)]
    if got != want:
        out.append(f"positional order {got} where the reference has {want}")
    out += [f"default {p}={p_lit[p]!r} where the reference has {v!r}"
            for p, v in j_lit.items() if p in p_lit and p not in skip and not _same(v, p_lit[p])]
    return out


SHARED_FUNCTIONS = [(rel, name) for rel in JAX_MODULES
                    for name in sorted(set(_functions(JAX / rel)) & set(_functions(PORT / rel)))]


def test_shared_functions_are_scanned():
    assert len(SHARED_FUNCTIONS) > 400
    assert ("panel/characteristics.py", "get_factors") in SHARED_FUNCTIONS
    assert ("specgrid/multiproc.py", "SpecGridWorkerPool.contract") in SHARED_FUNCTIONS


@pytest.mark.parametrize("rel", sorted({rel for rel, _ in SHARED_FUNCTIONS}))
def test_port_functions_take_the_reference_calls(rel):
    failures = {name: param_failures(rel, name) for r, name in SHARED_FUNCTIONS if r == rel}
    failures = {k: v for k, v in failures.items() if v}
    assert not failures, f"{rel}: {failures}"


def test_param_allowlist_has_no_stale_entry():
    """Every ``ALLOWED_PARAMS`` entry names a function both packages define
    and is needed: without it that function's check fails."""
    shared = set(SHARED_FUNCTIONS)
    stale = []
    for key, reason in ALLOWED_PARAMS.items():
        assert reason, key
        rel, name, _ = key.split(":")
        if (rel, name) not in shared:
            stale.append(key)
            continue
        rest = {k: v for k, v in ALLOWED_PARAMS.items() if k != key}
        if not param_failures(rel, name, allowed=rest):
            stale.append(key)
    assert not stale, f"parameter allowlist entries no check needs: {stale}"


@pytest.mark.parametrize("rel, name, old, new, expect", [
    ("panel/characteristics.py", "get_factors",
     "    crsp_comp: Optional[pd.DataFrame],\n    crsp_d: Optional[pd.DataFrame],\n",
     "    crsp_d: Optional[pd.DataFrame],\n    crsp_comp: Optional[pd.DataFrame],\n",
     "positional order"),
    ("ops/fama_macbeth.py", "fama_macbeth", ', guard=None):', '):', "missing guard"),
    ("pipeline.py", "build_panel_prepared", "    include_turnover: Optional[bool] = None,\n    *,",
     "    include_turnover: Optional[bool] = False,\n    *,", "default include_turnover"),
    ("reporting/figure1.py", "create_figure_1",
     "    save_plot: bool = False,\n    output_dir=None,\n", "", "missing save_plot"),
])
def test_param_check_sees_a_changed_signature(tmp_path, rel, name, old, new, expect):
    """The check fails on a call the port would bind otherwise: a copy of
    one port module with one signature changed as the port's had it."""
    copy = tmp_path / "port"
    (copy / rel).parent.mkdir(parents=True)
    text = (PORT / rel).read_text()
    assert old in text
    (copy / rel).write_text(text.replace(old, new, 1))
    assert param_failures(rel, name) == []
    assert any(f.startswith(expect) for f in param_failures(rel, name, root=copy))
