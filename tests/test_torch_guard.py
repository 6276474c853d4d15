"""The port's guard layer vs the JAX package's, at float64 on the CPU.

- ``panel_probe``: the same panel gives the same summary key for key
  (counts exact, moments at rtol 1e-12);
- the severity ladder on planted faults: the same rule names, severities
  and error class names in both packages;
- a clean guarded ``run_pipeline(synthetic=True)`` records the same
  sentinel sites in the same order and the same ``audit.as_dict()`` in both
  packages, and so does a guarded run of the sentinel-bearing entry points
  (``monthly_cs_ols``, ``fama_macbeth``, ``run_spec_grid``) over a panel
  with planted overflow months (the panel contract stops such a month
  before the pipeline's solves);
- with the guard off the sentinel helpers never run (they are patched to
  raise) and every table is bit-identical to the guarded run's;
- each package's ``audit.json`` is read by the other's drift sentinel: the
  same panel keys alike (``_pipeline_fingerprint``), a clean rerun passes,
  and a tampered column mean raises ``DriftDetectedError`` in both without
  the manifest being rewritten.

The synthetic frames are generated once per package and handed to both
pipelines (``tests/test_torch_ingest.py`` holds the generators equal).
"""

import dataclasses
import json
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu import pipeline as jax_pipeline
from fm_returnprediction_tpu.data import synthetic as jax_synthetic
from fm_returnprediction_tpu.guard import checks as jax_checks
from fm_returnprediction_tpu.guard import contracts as jax_contracts
from fm_returnprediction_tpu.guard import drift as jax_drift
from fm_returnprediction_tpu.ops.fama_macbeth import fama_macbeth as jax_fama_macbeth
from fm_returnprediction_tpu.ops.ols import monthly_cs_ols as jax_monthly_cs_ols
from fm_returnprediction_tpu.panel.dense import DensePanel as JaxDensePanel
from fm_returnprediction_tpu.specgrid import Spec as JaxSpec
from fm_returnprediction_tpu.specgrid import SpecGrid as JaxSpecGrid
from fm_returnprediction_tpu.specgrid import run_spec_grid as jax_run_spec_grid
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.data import synthetic as port_synthetic
from fm_returnprediction_tpu_torch.guard import checks as port_checks
from fm_returnprediction_tpu_torch.guard import contracts as port_contracts
from fm_returnprediction_tpu_torch.guard import drift as port_drift
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth as port_fama_macbeth
from fm_returnprediction_tpu_torch.ops.ols import monthly_cs_ols as port_monthly_cs_ols
from fm_returnprediction_tpu_torch.panel.dense import DensePanel as PortDensePanel
from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid as port_run_spec_grid
from fm_returnprediction_tpu_torch.specgrid.specs import Spec as PortSpec
from fm_returnprediction_tpu_torch.specgrid.specs import SpecGrid as PortSpecGrid

pytestmark = pytest.mark.torch_port

CFG = dict(n_firms=100, n_months=120)


def _copy(frames):
    return {k: v.copy() for k, v in frames.items()}


class _SiteLog:
    """Wraps a package's ``checks.record`` and logs the sites it records.
    JAX skips a record whose counters are tracers (an inner call inside an
    outer program): the log skips those too."""

    def __init__(self, checks):
        self.checks, self.orig, self.sites = checks, checks.record, []

    def __enter__(self):
        def record(site, values):
            if not any(isinstance(v, jax.core.Tracer) for v in values.values()):
                self.sites.append(site)
            return self.orig(site, values)

        self.checks.record = record
        return self

    def __exit__(self, *exc):
        self.checks.record = self.orig


@pytest.fixture(scope="module")
def frames():
    return (jax_synthetic.generate_synthetic_wrds(jax_synthetic.SyntheticConfig(**CFG)),
            port_synthetic.generate_synthetic_wrds(port_synthetic.SyntheticConfig(**CFG)))


@pytest.fixture
def cached_frames(frames, monkeypatch):
    """Both pipelines take the module's frames instead of generating."""
    jax_frames, port_frames = frames
    monkeypatch.setattr(jax_pipeline, "generate_synthetic_wrds",
                        lambda cfg=None: _copy(jax_frames))
    monkeypatch.setattr(port_pipeline, "generate_synthetic_wrds",
                        lambda cfg=None: _copy(port_frames))


def _jax_run(audit_dir, **kw):
    return jax_pipeline.run_pipeline(
        synthetic=True, synthetic_config=jax_synthetic.SyntheticConfig(**CFG),
        dtype=np.float64, audit_dir=audit_dir, compile_pdf=False, **kw)


def _port_run(audit_dir, **kw):
    return port_pipeline.run_pipeline(
        synthetic=True, synthetic_config=port_synthetic.SyntheticConfig(**CFG),
        device="cpu", dtype=torch.float64, audit_dir=audit_dir, **kw)


@pytest.fixture(scope="module")
def guarded(frames, tmp_path_factory):
    """One guarded run per package on the same frames, sites logged, each
    writing its audit manifest."""
    jax_frames, port_frames = frames
    dirs = {name: tmp_path_factory.mktemp(f"audit_{name}") for name in ("jax", "port")}
    saved = (jax_pipeline.generate_synthetic_wrds, port_pipeline.generate_synthetic_wrds)
    jax_pipeline.generate_synthetic_wrds = lambda cfg=None: _copy(jax_frames)
    port_pipeline.generate_synthetic_wrds = lambda cfg=None: _copy(port_frames)
    try:
        jax_checks.reset()
        port_checks.reset()
        with _SiteLog(jax_checks) as jax_log:
            jax_res = _jax_run(dirs["jax"], guard=True)
        with _SiteLog(port_checks) as port_log:
            port_res = _port_run(dirs["port"], guard=True)
    finally:
        jax_pipeline.generate_synthetic_wrds, port_pipeline.generate_synthetic_wrds = saved
    return dict(jax=jax_res, port=port_res, jax_sites=jax_log.sites,
                port_sites=port_log.sites, dirs=dirs)


# -- the panel probe and the severity ladder --------------------------------


def test_panel_probe_matches(guarded):
    panel = guarded["jax"].panel
    want = jax_contracts.panel_probe(panel)
    got = port_contracts.panel_probe(PortDensePanel(
        values=torch.as_tensor(np.asarray(panel.values)), mask=np.asarray(panel.mask),
        months=np.asarray(panel.months), ids=np.asarray(panel.ids),
        var_names=list(panel.var_names)))
    assert got.keys() == want.keys()
    for key in ("kind", "shape", "dtype", "mask_total", "mask_min_month"):
        assert got[key] == want[key], key
    assert list(got["columns"]) == list(want["columns"])
    for name, col in want["columns"].items():
        assert got["columns"][name].keys() == col.keys(), name
        for key in ("finite", "inf"):
            assert got["columns"][name][key] == col[key], (name, key)
        for key in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(got["columns"][name][key], col[key], rtol=1e-12,
                                       atol=0, err_msg=f"{name}.{key}")


def _tiny(t=10, n=8, seed=3):
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((t, n, 3)) * 0.1
    months = (np.datetime64("2000-01-31", "ns")
              + np.arange(t) * np.timedelta64(31, "D").astype("timedelta64[ns]"))
    return dict(values=values, mask=np.ones((t, n), bool), months=months,
                ids=np.arange(100, 100 + n), var_names=["retx", "size", "bm"])


def _duplicated_id(p):
    p["ids"][1] = p["ids"][0]


def _permuted_firms(p):
    perm = np.random.default_rng(0).permutation(len(p["ids"]))
    p["ids"], p["values"], p["mask"] = p["ids"][perm], p["values"][:, perm], p["mask"][:, perm]


def _inf_entry(p):
    p["values"][0, 0, 1] = np.inf


def _scale_spike(p):
    p["values"][0, 0, 1] = 1e20


def _stale_month(p):
    p["months"][-1] = p["months"][-2]


def _impossible_return(p):
    p["values"][0, 0, 0] = -1.5


def _dead_column(p):
    p["values"][:, :, 2] = np.nan


def _flat_values(p):
    p["values"] = p["values"][:, :, 0]


PANEL_FAULTS = {  # fault → (error class name or None, rules recorded)
    "clean": (lambda p: None, None, []),
    "duplicated_id": (_duplicated_id, "ContractViolationError", ["panel.key_unique"]),
    "permuted_firms": (_permuted_firms, None, ["panel.ids_sorted"]),
    "inf_entry": (_inf_entry, "ContractViolationError", ["panel.value_bounds"]),
    "scale_spike": (_scale_spike, "ContractViolationError", ["panel.value_bounds"]),
    "stale_month": (_stale_month, "ContractViolationError", ["panel.calendar_monotone"]),
    "impossible_return": (_impossible_return, "ContractViolationError",
                          ["panel.return_bounds_low"]),
    "dead_column": (_dead_column, None, ["panel.nan_budget"]),
    "unreadable": (_flat_values, "ContractViolationError", ["panel.schema"]),
}


def _outcome(fn, audit):
    """(error class name, guard-warning class names, (rule, severity) pairs,
    quarantined, whether the call returned None) of one guarded call."""
    err, out = None, None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn(audit)
        except Exception as exc:  # noqa: BLE001 — the class name is compared
            err = type(exc).__name__
    warned = sorted({type(w.message).__name__ for w in caught
                     if type(w.message).__name__ == "GuardWarning"})
    return (err, warned, [(v.rule, v.severity) for v in audit.violations],
            audit.quarantined, out is None)


@pytest.mark.parametrize("fault", list(PANEL_FAULTS))
def test_panel_severity_ladder_matches(fault):
    plant, err, rules = PANEL_FAULTS[fault]
    fields = _tiny()
    plant(fields)
    jax_panel = JaxDensePanel(**fields)
    port_panel = PortDensePanel(**{**fields, "values": torch.as_tensor(fields["values"])})
    want = _outcome(lambda audit: jax_contracts.check_panel(
        jax_panel, dtype=np.float64, audit=audit), jax_contracts.AuditRecord())
    got = _outcome(lambda audit: port_contracts.check_panel(
        port_panel, dtype=torch.float64, audit=audit), port_contracts.AuditRecord())
    assert got == want
    assert got[0] == err and [rule for rule, _ in got[2]] == rules
    assert got[1] == (["GuardWarning"] if rules and err is None else [])


@pytest.mark.parametrize("frame", ["empty", "nan_flood", "formatted_table_2"])
def test_frame_contracts_match(frame, guarded):
    df = {"empty": pd.DataFrame(),
          "nan_flood": pd.DataFrame(np.full((3, 2), np.nan), columns=["a", "b"]),
          "formatted_table_2": guarded["port"].table_2}[frame]
    want = _outcome(lambda audit: jax_contracts.check_frame(df, "table_1", audit),
                    jax_contracts.AuditRecord())
    got = _outcome(lambda audit: port_contracts.check_frame(df, "table_1", audit),
                   port_contracts.AuditRecord())
    assert got == want
    rules = {"empty": ["table_1.nonempty"], "nan_flood": ["table_1.nonfinite_flood"],
             "formatted_table_2": []}[frame]
    assert [rule for rule, _ in got[2]] == rules


@pytest.mark.parametrize("poison", ["clean", "nan_gram", "bad_window"])
def test_serving_state_screen_matches(poison, guarded):
    def poisoned(state):
        if poison == "nan_gram":
            gram = state.gram.copy()
            gram[3] = np.nan
            return dataclasses.replace(state, gram=gram)
        if poison == "bad_window":
            return dataclasses.replace(state, min_periods=state.window + 1)
        return state

    out = {}
    for side, contracts in (("jax", jax_contracts), ("port", port_contracts)):
        state = poisoned(guarded[side].serving_state)
        out[side] = _outcome(lambda audit: contracts.screen_artifact(
            "serving_state", state, contracts.serving_state_rules(), audit),
            contracts.AuditRecord())
    assert out["port"] == out["jax"]
    err, warned, rules, quarantined, dropped = out["port"]
    assert err is None and dropped == (poison != "clean")
    assert quarantined == ([] if poison == "clean" else ["serving_state"])
    assert rules == {"clean": [], "nan_gram": [("serving_state.stats_finite", "quarantine")],
                     "bad_window": [("serving_state.window", "quarantine")]}[poison]


# -- sentinel sites and the audit record -------------------------------------


def test_clean_guarded_run_records_the_same_sites(guarded):
    assert guarded["port_sites"] == guarded["jax_sites"]
    assert guarded["port_sites"].count("specgrid.grid_program") == 2


def test_clean_guarded_run_audit_matches(guarded):
    assert guarded["port"].audit.as_dict() == guarded["jax"].audit.as_dict()
    assert guarded["port"].audit.report() == "guards: clean"


def _planted():
    rng = np.random.default_rng(5)
    t, n, p = 24, 40, 3
    x = rng.standard_normal((t, n, p))
    y = 0.1 * rng.standard_normal((t, n))
    y[7, :5] = 1e300           # R² overflows: sse and sst are both inf
    x[11, :, 1] *= 1e-170      # a column at 1e-170: the QR condition proxy trips
    x[13, :, 2] = 1e200        # the Gram entry x² overflows
    return y, x, np.ones((t, n), bool)


def test_planted_months_record_the_same_sites_and_audit():
    y, x, mask = _planted()
    specs = [(f"m{k}", tuple(f"c{i}" for i in range(k)), "u") for k in (2, 3)]
    runs = {}
    for side, checks, contracts, ols, fm, grid_run, grid in (
            ("jax", jax_checks, jax_contracts, jax_monthly_cs_ols, jax_fama_macbeth,
             jax_run_spec_grid, JaxSpecGrid(tuple(JaxSpec(*s) for s in specs))),
            ("port", port_checks, port_contracts, port_monthly_cs_ols, port_fama_macbeth,
             port_run_spec_grid, PortSpecGrid(tuple(PortSpec(*s) for s in specs)))):
        arr = jnp.asarray if side == "jax" else torch.as_tensor
        checks.reset()
        with checks.guards(True), _SiteLog(checks) as log:
            ols(arr(y), arr(x), arr(mask))
            fm(arr(y), arr(x), arr(mask))
            res = grid_run(arr(y), arr(x), {"u": arr(mask)}, grid)
        audit = contracts.AuditRecord()
        audit.record_counters(checks.drain())
        runs[side] = (log.sites, audit.as_dict(), res.referee_specs)
        checks.reset()
    assert runs["port"] == runs["jax"]
    # the overflowed Gram leaves both specs to the referee, whose solves
    # record under ols.fama_macbeth beside the direct call
    assert runs["port"][0] == ["ols.monthly_cs_ols", "ols.fama_macbeth",
                               "specgrid.grid_program", "ols.fama_macbeth",
                               "ols.fama_macbeth"]
    assert runs["port"][1]["counters"] == {
        "ols.monthly_cs_ols.nonfinite_r2_months": 1,
        "ols.monthly_cs_ols.cond_exceeded_months": 2,
        "ols.fama_macbeth.nonfinite_r2_months": 3,
        "specgrid.grid_program.gram_nonfinite_entries": 2,
    }


def test_drain_folds_device_and_host_counts():
    for checks in (jax_checks, port_checks):
        checks.reset()
    port_checks.record("a", {"x": torch.tensor(2), "y": 3, "z": torch.tensor(0)})
    port_checks.record("a", {"x": torch.tensor(1, dtype=torch.int32)})
    jax_checks.record("a", {"x": jnp.asarray(2), "y": 3, "z": jnp.asarray(0)})
    jax_checks.record("a", {"x": jnp.asarray(1, dtype=jnp.int32)})
    assert port_checks.drain() == jax_checks.drain() == {"a.x": 3, "a.y": 3}
    for checks in (jax_checks, port_checks):
        checks.reset()


@pytest.mark.parametrize("raw,armed", [("on", True), ("off", False), ("0", False),
                                       ("false", False), ("NO", False)])
def test_guard_switch_reads_fmrp_guard(raw, armed, monkeypatch):
    monkeypatch.setenv("FMRP_GUARD", raw)
    assert port_checks._env_default() is jax_checks._env_default() is armed


def _bomb(*args, **kwargs):
    raise AssertionError("a guard helper ran with the guard off")


def test_guard_off_is_bit_identical_and_runs_no_helper(guarded, cached_frames, monkeypatch):
    for name in ("record", "record_cs_host", "record_fm_host", "nonfinite_count",
                 "cs_counters", "fm_counters", "cond_limit"):
        monkeypatch.setattr(port_checks, name, _bomb)
    for name in ("panel_probe", "check_panel", "check_frame", "screen_artifact"):
        monkeypatch.setattr(port_contracts, name, _bomb)
    off = _port_run(None, guard=False)
    on = guarded["port"]
    assert off.audit.as_dict() == {"violations": [], "counters": {}, "quarantined": []}
    assert "guard_panel_contracts" not in off.stage_seconds
    np.testing.assert_array_equal(off.panel.values.numpy(), on.panel.values.numpy())
    assert off.table_1.equals(on.table_1)
    assert off.table_2.equals(on.table_2)
    for key, cell in on.table_2_cells.items():
        for name, value in cell.items():
            np.testing.assert_array_equal(off.table_2_cells[key][name], value)
    assert off.decile_table.equals(on.decile_table)
    for name, frame in on.figure_1.items():
        assert off.figure_1[name].equals(frame), name
    for field in dataclasses.fields(on.serving_state):
        np.testing.assert_array_equal(getattr(off.serving_state, field.name),
                                      getattr(on.serving_state, field.name))


# -- the drift manifest across the two packages ------------------------------


def test_pipeline_fingerprints_match(guarded):
    salt = json.dumps(vars(port_synthetic.SyntheticConfig(**CFG)), sort_keys=True,
                      default=str)
    want = jax_pipeline._pipeline_fingerprint(guarded["jax"].panel, np.float64, salt)
    got = port_pipeline._pipeline_fingerprint(guarded["port"].panel, torch.float64, salt)
    assert got == want
    manifests = {side: json.loads((guarded["dirs"][side] / port_drift.MANIFEST_NAME)
                                  .read_text()) for side in ("jax", "port")}
    assert manifests["jax"]["fingerprint"] == manifests["port"]["fingerprint"] == got
    assert manifests["jax"]["artifacts"].keys() == manifests["port"]["artifacts"].keys()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_audit_manifest_cross_read(writer, reader, guarded, cached_frames, tmp_path):
    audit_dir = tmp_path / "audit"
    shutil.copytree(guarded["dirs"][writer], audit_dir)
    run = {"jax": _jax_run, "port": _port_run}[reader]
    error = {"jax": jax_drift, "port": port_drift}[reader].DriftDetectedError
    run(audit_dir)  # the other package's numbers are inside the band

    manifest = audit_dir / port_drift.MANIFEST_NAME
    meta = json.loads(manifest.read_text())
    col = next(iter(meta["artifacts"]["table_2"]["columns"].values()))
    col["mean"] = (col["mean"] or 0.0) + 1.0
    meta["artifacts"]["table_2"]["sha256"] = "not-the-same"
    manifest.write_text(json.dumps(meta))
    before = manifest.read_bytes()
    with pytest.raises(error, match="drift.table_2") as exc:
        run(audit_dir)
    assert type(exc.value).__name__ == "DriftDetectedError"
    assert manifest.read_bytes() == before
