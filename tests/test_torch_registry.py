"""The port's registry (``fm_returnprediction_tpu_torch.registry``) vs the
JAX package's, on the CPU.

- **The store.** Entries either package writes list, verify and yield
  their serving state in the other (the same layout, meta keys and
  ``SCHEMA_VERSION``); ``gc`` drops the same entries from the same tree;
  corruption is the typed ``CorruptArtifactError`` in both; racing
  publisher processes never expose a torn entry.
- **The executable plane.** The reference stores serialized XLA
  executables; its round-trip tests are red on this tree
  (``tests/test_registry.py::test_executable_roundtrip_bit_identical`` and
  ``::test_new_process_deserialize_bit_identical``), so the port's tests
  here pin the port's own contract instead: a populated plane answers
  ``cuda_build.build_kernels`` with 0 builds and no nvcc process (a
  stand-in payload on the CPU, where there is no nvcc and no card), and an
  absent entry, a torn meta, environment skew, a manifest mismatch or a
  library that will not load is a counted miss that builds fresh.
- **The warm pool.** ``warm_from_registry`` starts a service with 0 builds
  and one capture per bucket, bit-identical to an in-place warm-up (the
  reference's zero-compile warm-pool test is red too:
  ``::test_warm_from_registry_zero_compile_and_bit_identical``).
- **The riders.** ``prepared_candidates`` routes through the armed root
  exactly as the reference does; the Gram bank's ``save_bank`` /
  ``load_bank`` round-trip (``tests/test_grambank.py:189-222``); the
  pipeline's ``registry_publish`` stage and its failure; the maintenance
  CLI.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.registry import artifacts as jax_rart
from fm_returnprediction_tpu.registry.__main__ import main as jax_registry_main
from fm_returnprediction_tpu.registry.store import Registry as JaxRegistry
from fm_returnprediction_tpu.serving.state import ServingState as JaxServingState
from fm_returnprediction_tpu.serving.state import build_serving_state as jax_build_state
from fm_returnprediction_tpu_torch import cuda_build
from fm_returnprediction_tpu_torch.registry import (
    CorruptArtifactError,
    Registry,
    WarmReport,
    active_registry,
    using_registry,
    warm_from_registry,
)
from fm_returnprediction_tpu_torch.registry import artifacts as rart
from fm_returnprediction_tpu_torch.registry import executables as rexe
from fm_returnprediction_tpu_torch.registry.__main__ import main as registry_main
from fm_returnprediction_tpu_torch.registry.store import META_FILE, _publish_lock
from fm_returnprediction_tpu_torch.serving import ERService, ServingState, build_serving_state
from fm_returnprediction_tpu_torch.telemetry import cost_ledger
from fm_returnprediction_tpu_torch.telemetry import metrics as tmetrics

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def reg_dir(tmp_path, monkeypatch):
    root = tmp_path / "registry"
    monkeypatch.setenv("FMRP_REGISTRY_DIR", str(root))
    return root


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(7)
    t, n, p = 30, 24, 3
    y = rng.standard_normal((t, n))
    x = rng.standard_normal((t, n, p))
    return y, x, np.ones((t, n), bool)


@pytest.fixture(scope="module")
def small_state(panel):
    y, x, mask = panel
    return build_serving_state(torch.from_numpy(y), torch.from_numpy(x),
                               torch.from_numpy(mask), window=12, min_periods=6)


def _leaves_equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                              equal_nan=True)
               for f in ("coef", "slopes_bar", "intercept_bar", "x_lo", "x_hi", "gram",
                         "moment", "n_obs", "month_valid"))


# -- the store, across packages ------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_written_by_one_package_reads_in_the_other(writer, tmp_path, panel,
                                                            small_state):
    """Serving state + a CSV artifact + a prepared slot published by one
    package: the other's ``ls`` sees the same rows, its ``verify`` finds
    nothing corrupt, and its ``load_serving_state`` yields the same leaves."""
    root = tmp_path / "reg"
    y, x, mask = panel
    csv = tmp_path / "frame.csv"
    csv.write_text("a,b\n1,2\n")
    if writer == "jax":
        state = jax_build_state(y, x, mask, window=12, min_periods=6)
        reg = JaxRegistry(root)
        assert jax_rart.put_serving_state(state, "fp-state", registry=reg) is not None
        assert jax_rart.put_files("frames", "fp-csv", [csv], registry=reg) is not None
        reader, other = Registry(root), reg
    else:
        state = small_state
        reg = Registry(root)
        assert rart.put_serving_state(state, "fp-state", registry=reg) is not None
        assert rart.put_files("frames", "fp-csv", [csv], registry=reg) is not None
        reader, other = JaxRegistry(root), reg
    slot = reg.prepared_root("slot01")
    slot.mkdir(parents=True)
    (slot / "base.values.npy").write_bytes(b"payload")
    (slot / "meta.json").write_text(json.dumps({"manifest": {"base.values.npy": {
        "sha256": hashlib.sha256(b"payload").hexdigest(), "size": 7}}}))

    def rows(r):
        return sorted((row["kind"], row["path"], row["bytes"], row["readable"])
                      for row in r.ls())

    assert rows(reader) == rows(other) and len(rows(reader)) == 3
    assert reader.verify(deep=True) == [] == other.verify(deep=True)
    if writer == "jax":
        loaded = rart.load_serving_state("fp-state", registry=reader)
        assert isinstance(loaded, ServingState)
    else:
        loaded = jax_rart.load_serving_state("fp-state", registry=reader)
        assert isinstance(loaded, JaxServingState)
    assert _leaves_equal(loaded, state) and loaded.xvars == state.xvars


def _gc_tree(root: Path, registry_cls) -> None:
    reg = registry_cls(root)
    for k, stamp in enumerate(("2026-01-01T00:00:01Z", "2026-01-01T00:00:03Z",
                               "2026-01-01T00:00:02Z")):
        reg.write_entry(reg.artifact_dir("frames", f"fp{k}"), {"a.csv": b"x" * (k + 1)},
                        {"kind": "artifact", "name": "frames", "created_at": stamp})
    reg.write_entry(reg.artifact_dir("serving_state", "only"), {"s.npz": b"s"},
                    {"kind": "artifact", "name": "serving_state",
                     "created_at": "2026-01-01T00:00:00Z"})
    torn = reg.artifact_dir("frames", "torn")
    torn.mkdir(parents=True)
    (torn / "a.csv").write_bytes(b"t")
    slot = reg.prepared_root("torn-slot")
    slot.mkdir(parents=True)
    (slot / "x.npy").write_bytes(b"x")


@pytest.mark.parametrize("keep", [0, 1, 2])
def test_gc_drops_the_same_entries_as_the_jax_gc(keep, tmp_path):
    """The same tree, collected by each package: the same rows dropped for
    the same reasons (newest ``keep`` per artifact name, torn entries and
    torn prepared slots always)."""
    _gc_tree(tmp_path / "a", Registry)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    got = Registry(tmp_path / "a").gc(keep=keep)
    want = JaxRegistry(tmp_path / "b").gc(keep=keep)
    assert got == want
    assert {r["reason"] for r in got} >= {"unreadable meta", "torn prepared slot"}
    assert sorted(p.name for p in (tmp_path / "a" / "artifacts" / "frames").iterdir()
                  if p.is_dir()) == \
        sorted(p.name for p in (tmp_path / "b" / "artifacts" / "frames").iterdir()
               if p.is_dir())


def test_artifact_roundtrip_and_corruption(reg_dir, tmp_path):
    src = tmp_path / "payload.csv"
    src.write_text("a,b\n1,2\n")
    entry = rart.put_files("frames", "fp1", [src])
    assert entry is not None
    got = rart.get_file("frames", "payload.csv", "fp1", deep=True)
    assert got is not None and got.read_text() == src.read_text()
    src.write_text("a,b\n3,4\n")
    rart.put_files("frames", "fp2", [src])
    assert rart.get_entry_dir("frames").name == "fp2"
    (entry / "payload.csv").write_text("a,b\n9,9\n")
    with pytest.raises(CorruptArtifactError):
        rart.get_file("frames", "payload.csv", "fp1", deep=True)
    assert any("fp1" in row["path"] for row in Registry(reg_dir).verify(deep=True))


def test_put_files_warns_and_returns_none_on_failure(reg_dir, tmp_path):
    """The reference's contract: a failed registration is a warning and
    ``None``, never an exception (the pipeline's publish stage is what
    turns a missing serving-state entry into a failure)."""
    with pytest.warns(UserWarning, match="artifact registration failed"):
        assert rart.put_files("frames", "fp", [tmp_path / "missing.csv"]) is None
    assert rart.get_entry_dir("frames", "fp") is None


def test_registry_is_off_unless_armed(monkeypatch, tmp_path, small_state):
    monkeypatch.delenv("FMRP_REGISTRY_DIR", raising=False)
    assert active_registry() is None
    assert rart.put_serving_state(small_state, "fp") is None
    assert rart.load_serving_state() is None
    with using_registry(tmp_path / "r") as reg:
        assert reg is not None and reg.root == tmp_path / "r"
        assert os.environ["FMRP_REGISTRY_DIR"] == str(tmp_path / "r")
    assert "FMRP_REGISTRY_DIR" not in os.environ


def test_write_entry_refuses_the_meta_name(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        Registry(tmp_path).write_entry(tmp_path / "e", {META_FILE: b"x"}, {})


_RACE_PUBLISHER = """
import sys
from fm_returnprediction_tpu_torch.registry.store import Registry

root, writer, rounds = sys.argv[1], sys.argv[2], int(sys.argv[3])
reg = Registry(root)
entry = reg.artifacts_root / "raced" / "fp"
for k in range(rounds):
    token = f"{writer}:{k}".encode() * 2048
    reg.write_entry(entry, {"a.bin": token, "b.bin": token},
                    {"kind": "race", "writer": writer, "round": k})
print("RACE_DONE", writer)
"""


def test_racing_publishers_never_expose_a_torn_entry(tmp_path):
    """Two publisher processes re-publish one entry; a reader holding the
    entry's publish lock only ever sees it absent or whole (both payloads
    from one writer, the manifest verifying deep)."""
    import time

    from fm_returnprediction_tpu_torch.registry import integrity

    root = tmp_path / "registry"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _RACE_PUBLISHER, str(root), w, "20"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for w in ("alpha", "beta")]
    reg = Registry(root)
    entry = reg.artifacts_root / "raced" / "fp"
    deadline = time.monotonic() + 120
    try:
        while any(p.poll() is None for p in procs):
            assert time.monotonic() < deadline, "racing publishers hung"
            entry.mkdir(parents=True, exist_ok=True)
            with _publish_lock(entry):
                if reg.read_meta(entry) is None:
                    continue
                try:
                    reg.verify_entry(entry, deep=True)
                except integrity.CorruptArtifactError as exc:
                    pytest.fail(f"reader observed a torn entry: {exc}")
                assert (entry / "a.bin").read_bytes() == (entry / "b.bin").read_bytes()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        out, _ = p.communicate(timeout=30)
        assert p.returncode == 0 and "RACE_DONE" in out, out
    assert reg.verify_entry(entry, deep=True)["kind"] == "race"


# -- the executable plane ------------------------------------------------------


@pytest.fixture
def plane(reg_dir, tmp_path, monkeypatch):
    """An armed registry, an empty build directory, and a clean library
    cache; nvcc absent (as on this machine) so any build attempt raises."""
    build = tmp_path / "build"
    monkeypatch.setenv(cuda_build.BUILD_DIR_ENV, str(build))
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "_FUNCS", {})
    monkeypatch.setattr(cuda_build, "_FETCHED", {})

    def no_nvcc():
        raise RuntimeError("nvcc was not found")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(rexe, "_ENV", None)
    return Registry(reg_dir), build


def _stand_in(tmp_path, name: str, seconds: float = 12.5) -> Path:
    """A stand-in payload stored under the kernel's real address."""
    path = tmp_path / f"standin_{name}.so"
    path.write_bytes(f"stand-in library for {name}".encode() * 64)
    assert rexe.store_library(name, cuda_build._signature(name), path,
                              compile_s=seconds) is not None
    return path


def _misses() -> dict:
    series = tmetrics.registry().collect().get("fmrp_registry_misses_total", {})
    return {(dict(k)["program"], dict(k)["reason"]): v for k, v in series.items()}


def test_populated_plane_answers_build_kernels_with_no_build(plane, tmp_path):
    reg, build = plane
    for name in cuda_build.KERNEL_SOURCES:
        _stand_in(tmp_path, name)
    runs0, seq0 = cuda_build.NVCC_RUNS, cost_ledger().last_seq
    from fm_returnprediction_tpu_torch.telemetry import recompile_watch

    with recompile_watch("fetch", warm=True) as watch:
        seconds = cuda_build.build_kernels()
    assert seconds == {name: 0.0 for name in cuda_build.KERNEL_SOURCES}
    assert cuda_build.NVCC_RUNS == runs0 and watch.grew == 0
    assert not build.exists() or not any(build.iterdir())
    for name in cuda_build.KERNEL_SOURCES:
        path, meta = cuda_build._FETCHED[name]
        assert path.is_relative_to(reg.executables_root)
        assert meta["program"] == f"cuda_kernel:{name}"
    fetched = [r for r in cost_ledger().since(seq0) if r.program == rexe.PROGRAM]
    assert [r.provenance for r in fetched] == ["fetched", "fetched"]
    assert all(r.saved_s == 12.5 for r in fetched)


@pytest.mark.parametrize("damage", ["absent", "unreadable meta", "environment skew",
                                    "manifest mismatch"])
def test_every_miss_is_counted_and_falls_back_to_a_build(damage, plane, tmp_path):
    reg, _ = plane
    name = "rolling"
    signature = cuda_build._signature(name)
    entry = reg.executable_dir(rexe.executable_key(name, signature))
    if damage != "absent":
        _stand_in(tmp_path, name)
    if damage == "unreadable meta":
        (entry / META_FILE).write_text("{torn")
    elif damage == "environment skew":
        meta = json.loads((entry / META_FILE).read_text())
        meta["torch"] = "0.0-other"
        (entry / META_FILE).write_text(json.dumps(meta))
    elif damage == "manifest mismatch":
        payload = entry / rexe.PAYLOAD_FILE
        blob = bytearray(payload.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        payload.write_bytes(bytes(blob))
    before = _misses().get((f"cuda_kernel:{name}", damage), 0)
    assert rexe.fetch_library(name, signature) is None
    assert _misses()[(f"cuda_kernel:{name}", damage)] == before + 1
    if damage == "manifest mismatch":
        assert not (entry / META_FILE).exists()  # the corrupt entry is dropped
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        cuda_build.build_kernels([name])          # the miss builds: no fallback


def test_a_fetched_library_that_will_not_load_is_a_miss(plane, tmp_path):
    _stand_in(tmp_path, "gram")
    before = _misses().get(("cuda_kernel:gram", "load failed"), 0)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        cuda_build.kernel_function("gram", "gram_error_string", [])
    assert _misses()[("cuda_kernel:gram", "load failed")] == before + 1
    assert "gram" not in cuda_build._FETCHED


def test_the_key_covers_the_source_and_the_environment(plane, monkeypatch):
    sig = cuda_build._signature("rolling")
    assert sig == rexe.library_signature(
        (cuda_build.CSRC / "rolling.cu").read_bytes(), cuda_build.NVCC_FLAGS)
    assert cuda_build.library_path("rolling").name == f"librolling_{sig[:16]}.so"
    key = rexe.executable_key("rolling", sig)
    assert rexe.executable_key("rolling", sig) == key
    assert rexe.executable_key("gram", sig) != key
    assert rexe.executable_key("rolling", rexe.library_signature(b"edited", ())) != key
    env = rexe.environment_key()
    assert set(env) == {"backend", "device_kind", "compute_capability", "nvcc", "torch",
                        "cuda"}
    monkeypatch.setattr(rexe, "_ENV", {**env, "compute_capability": "sm_80"})
    assert rexe.executable_key("rolling", sig) != key


def test_publish_libraries_stores_what_was_built_once(plane, tmp_path, monkeypatch):
    reg, build = plane
    build.mkdir()
    built = cuda_build.library_path("rolling")
    built.write_bytes(b"a built library")
    monkeypatch.setitem(cuda_build._LIBS, "rolling", object())
    out = cuda_build.publish_libraries()
    assert list(out) == ["rolling"]
    meta = reg.read_meta(out["rolling"])
    assert meta["kind"] == "executable" and meta["source_sha256"] == \
        cuda_build._signature("rolling")
    assert cuda_build.publish_libraries() == out
    assert reg.read_meta(out["rolling"]) == meta   # not re-stored
    assert reg.verify(deep=True) == []
    # the JAX package's maintenance surface lists and verifies the entry too
    assert JaxRegistry(reg.root).verify(deep=True) == []
    assert [r["kind"] for r in JaxRegistry(reg.root).ls()] == ["executable"]


def test_gc_drops_skewed_libraries_only_on_request(plane, tmp_path):
    reg, _ = plane
    _stand_in(tmp_path, "rolling")
    entry = reg.executable_dir(rexe.executable_key("rolling", cuda_build._signature("rolling")))
    meta = json.loads((entry / META_FILE).read_text())
    meta["nvcc"] = "0.1"
    (entry / META_FILE).write_text(json.dumps(meta))
    assert reg.gc(keep=10) == []
    assert [r["reason"] for r in reg.gc(keep=10, drop_skewed=True)] == ["environment skew"]


# -- the warm pool -------------------------------------------------------------


def test_warm_from_registry_has_no_build_and_is_bit_identical(reg_dir, small_state,
                                                              monkeypatch):
    rart.put_serving_state(small_state, "fpW")
    svc, report = warm_from_registry(max_batch=32, strict=True, device="cpu")
    try:
        assert isinstance(report, WarmReport) and report.zero_compile
        assert report.builds == 0 and report.fetched == 0
        assert report.captures == len(svc.executor.buckets()) == 6
        assert all(p == "serving_bucket@eager" for p in report.programs)
        m = int(np.nonzero(small_state.have_coef())[0][-1])
        xs = np.linspace(-1.0, 1.0, small_state.n_predictors * 5).reshape(
            5, small_state.n_predictors)
        got = svc.query_many([m] * 5, xs)
    finally:
        svc.close()
    monkeypatch.delenv("FMRP_REGISTRY_DIR")
    with ERService(small_state, max_batch=32, device="cpu") as ref:
        want = ref.query_many([m] * 5, xs)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(want).all()


def test_warm_from_registry_strict_raises_on_a_build_not_a_capture(reg_dir, small_state,
                                                                    tmp_path, monkeypatch):
    build = tmp_path / "build"
    monkeypatch.setenv(cuda_build.BUILD_DIR_ENV, str(build))

    class Building(ERService):
        def __init__(self, *a, **kw):
            build.mkdir(exist_ok=True)
            (build / "libnew.so").write_bytes(b"x")   # what an nvcc build leaves
            super().__init__(*a, **kw)

    with pytest.warns(UserWarning, match="grew the nvcc build cache"):
        with pytest.raises(RuntimeError, match="built a kernel"):
            warm_from_registry(state=small_state, max_batch=4, strict=True,
                               service_cls=Building, device="cpu")
    svc, report = warm_from_registry(state=small_state, max_batch=4, strict=True,
                                     device="cpu")
    svc.close()
    assert report.builds == 0 and report.captures == 3


def test_warm_from_registry_needs_a_state_source(reg_dir, monkeypatch):
    with pytest.raises(FileNotFoundError, match="no serving_state"):
        warm_from_registry(device="cpu")
    monkeypatch.delenv("FMRP_REGISTRY_DIR")
    with pytest.raises(ValueError, match="needs a state"):
        warm_from_registry(device="cpu")


# -- riders --------------------------------------------------------------------


def test_prepared_candidates_route_through_the_registry_as_the_reference(tmp_path,
                                                                         monkeypatch):
    from fm_returnprediction_tpu.data.prepared import prepared_candidates as jax_cands
    from fm_returnprediction_tpu_torch.data.prepared import prepared_candidates

    raw = tmp_path / "raw"
    monkeypatch.delenv("FMRP_REGISTRY_DIR", raising=False)
    assert prepared_candidates(raw) == jax_cands(raw) == [raw / "_prepared"]
    monkeypatch.setenv("FMRP_REGISTRY_DIR", str(tmp_path / "reg"))
    cands = prepared_candidates(raw)
    assert cands == jax_cands(raw) and len(cands) == 2
    assert cands[0].is_relative_to(tmp_path / "reg") and cands[1] == raw / "_prepared"
    assert prepared_candidates(tmp_path / "raw2")[0] != cands[0]


@pytest.fixture(scope="module")
def bank():
    from fm_returnprediction_tpu_torch.specgrid.cellspace import CellSpace
    from fm_returnprediction_tpu_torch.specgrid.grambank import build_bank

    rng = np.random.default_rng(3)
    t, n = 40, 30
    y = rng.standard_normal((t, n))
    x = rng.standard_normal((t, n, 2))
    masks = {"All stocks": rng.random((t, n)) > 0.1}
    space = CellSpace(regressor_sets=(("m1", ("a",)), ("m2", ("a", "b"))),
                      universes=("All stocks",), windows=(("full", None),))
    return build_bank(y, x, masks, space, fingerprint="test-bank", device="cpu")


def test_bank_save_load_roundtrip(bank, reg_dir):
    from fm_returnprediction_tpu_torch.specgrid.grambank import load_bank, save_bank

    entry = save_bank(bank)
    assert entry is not None and (entry / "bank.npz").exists()
    args = (bank.union, bank.universes, bank.uidx, bank.col_sel, bank.dtype)
    got = load_bank("test-bank", *args, bank.months, device="cpu")
    assert got is not None
    for f in ("gram", "moment", "n", "ysum", "yy", "center", "months", "uidx", "col_sel"):
        np.testing.assert_array_equal(getattr(got, f), getattr(bank, f), err_msg=f)
    assert got.union == bank.union and got.pair_labels == bank.pair_labels
    assert got.meta == bank.meta and got.meta["device"] == "cpu"
    assert load_bank("other", *args, bank.months, device="cpu") is None
    assert load_bank("test-bank", *args, np.arange(bank.n_months + 1), device="cpu") is None
    # a bank contracted on the CPU is another entry than the card's
    from fm_returnprediction_tpu_torch.specgrid.grambank import bank_key

    keys = {dev: bank_key("test-bank", *args, bank.months, "highest", device=dev)
            for dev in ("cpu", "cuda")}
    assert keys["cpu"] != keys["cuda"] and entry.name == keys["cpu"]


def test_bank_not_banked_without_a_registry(bank, monkeypatch):
    from fm_returnprediction_tpu_torch.specgrid.grambank import load_bank, save_bank

    monkeypatch.delenv("FMRP_REGISTRY_DIR", raising=False)
    assert save_bank(bank) is None
    assert load_bank("test-bank", bank.union, bank.universes, bank.uidx, bank.col_sel,
                     bank.dtype, bank.months, device="cpu") is None


def test_bank_load_misses_on_corruption_and_schema_skew(bank, reg_dir):
    from fm_returnprediction_tpu_torch.specgrid.grambank import load_bank, save_bank

    entry = save_bank(bank)
    args = ("test-bank", bank.union, bank.universes, bank.uidx, bank.col_sel, bank.dtype,
            bank.months)
    (entry / "bank.npz").write_bytes(b"short")
    with pytest.warns(UserWarning, match="unreadable"):
        assert load_bank(*args, device="cpu") is None
    entry = save_bank(bank)
    meta = json.loads((entry / META_FILE).read_text())
    meta["bank_schema"] = 99
    (entry / META_FILE).write_text(json.dumps(meta))
    assert load_bank(*args, device="cpu") is None


@pytest.fixture(scope="module")
def prepared_inputs():
    from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs

    return make_smoke_inputs(n_firms=60, n_months=48, dtype=np.float64)


def test_run_pipeline_publishes_into_the_armed_registry(prepared_inputs, tmp_path,
                                                        monkeypatch):
    from fm_returnprediction_tpu_torch.pipeline import run_pipeline

    monkeypatch.delenv("FMRP_REGISTRY_DIR", raising=False)
    root = tmp_path / "reg"
    res = run_pipeline(dense_base=prepared_inputs[0], compact_daily=prepared_inputs[1], device="cpu", dtype=torch.float64,
                       make_figure=False, output_dir=tmp_path / "out",
                       audit_dir=tmp_path / "audit", registry_dir=root)
    assert "registry_publish" in res.stage_seconds
    assert "FMRP_REGISTRY_DIR" not in os.environ
    reg = Registry(root)
    names = sorted(r["path"].split("/")[1] for r in reg.ls())
    assert names == ["audit_manifest", "serving_state"]
    assert reg.verify(deep=True) == []
    loaded = rart.load_serving_state(registry=reg)
    assert _leaves_equal(loaded, res.serving_state)
    # the entry is the npz the artifact writer saved, byte for byte
    entry = rart.get_entry_dir("serving_state", registry=reg)
    assert (entry / "serving_state.npz").read_bytes() == \
        (tmp_path / "out" / "serving_state.npz").read_bytes()


def test_registry_publish_raises_when_the_state_is_not_there(prepared_inputs, tmp_path,
                                                             monkeypatch):
    """Unlike the reference (which warns), the port's publish stage fails
    the run when the armed registry lacks the run's serving state."""
    from fm_returnprediction_tpu_torch import pipeline

    monkeypatch.setattr(rart, "put_serving_state", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="holds no serving-state entry"):
        pipeline.run_pipeline(dense_base=prepared_inputs[0], compact_daily=prepared_inputs[1], device="cpu", dtype=torch.float64,
                              make_figure=False, registry_dir=tmp_path / "reg")


def test_cli_ls_verify_gc(reg_dir, small_state, capsys):
    rart.put_serving_state(small_state, "fp-cli")
    assert registry_main(["--registry-dir", str(reg_dir), "ls"]) == 0
    assert "serving_state" in capsys.readouterr().out
    assert registry_main(["--registry-dir", str(reg_dir), "verify"]) == 0
    assert jax_registry_main(["--registry-dir", str(reg_dir), "verify"]) == 0
    entry = rart.get_entry_dir("serving_state", "fp-cli")
    payload = entry / "serving_state.npz"
    payload.write_bytes(payload.read_bytes()[:-4] + b"XXXX")
    assert registry_main(["--registry-dir", str(reg_dir), "verify"]) == 1
    assert registry_main(["--registry-dir", str(reg_dir), "gc", "--keep", "0",
                          "--dry-run"]) == 0
    assert (entry / META_FILE).exists()
    assert registry_main(["--registry-dir", str(reg_dir), "gc", "--keep", "0"]) == 0
    assert not (entry / META_FILE).exists()


def test_cli_no_root_exits_2(monkeypatch, capsys):
    monkeypatch.delenv("FMRP_REGISTRY_DIR", raising=False)
    assert registry_main(["ls"]) == 2
    assert "no registry root" in capsys.readouterr().err
    out = subprocess.run([sys.executable, "-m", "fm_returnprediction_tpu_torch.registry",
                          "verify"], cwd=REPO, capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items()
                              if k != "FMRP_REGISTRY_DIR"}, timeout=120)
    assert out.returncode == 2, out.stderr
