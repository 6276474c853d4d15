"""The port's prepared-inputs slot (``data.prepared``) vs the JAX package's.

- a v3 slot written by either package loads in the other, with the same
  fingerprint for the same raw directory, dtype and salt, and every array
  bit-equal to what was written;
- the make-style staleness rule: the fingerprint is stable, and moves with
  a raw file's mtime, the dtype and the salt;
- a damaged slot (a missing or truncated payload) is a warned rebuild, and
  ``FMRP_PREPARED_VERIFY=1`` catches a flipped payload byte the size check
  cannot see; an older layout is a clean miss whose payloads the next save
  removes;
- ``PREPARED_CACHE=0`` neither reads nor writes the slot;
- ``run_pipeline(raw_data_dir=...)`` writes the slot cold and maps it warm:
  the warm run marks ``load_raw_data`` skipped, ingests nothing, writes
  nothing into the read-only maps, and its tables, panel and serving state
  are bit-identical to the cold run's; the JAX pipeline's warm run loads
  the slot the port wrote.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu import settings as jax_settings
from fm_returnprediction_tpu.data import prepared as jax_prepared
from fm_returnprediction_tpu.pipeline import build_panel as jax_build_panel
from fm_returnprediction_tpu.pipeline import load_raw_data as jax_load_raw_data
from fm_returnprediction_tpu.pipeline import run_pipeline as jax_run_pipeline
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.data import prepared as port_prepared
from fm_returnprediction_tpu_torch.data.synthetic import SyntheticConfig, write_synthetic_cache

pytestmark = pytest.mark.torch_port

CFG = SyntheticConfig(n_firms=60, n_months=130)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw_prepared")
    write_synthetic_cache(d, CFG)
    return d


@pytest.fixture(scope="module")
def products(raw_dir):
    """Each package's host products of the raw directory at float64."""
    capture = {}
    port_pipeline.build_panel(port_pipeline.load_raw_data(raw_dir), dtype=torch.float64,
                              device="cpu", capture=capture)
    jax_capture = {}
    jax_build_panel(jax_load_raw_data(raw_dir), dtype=np.float64, capture=jax_capture)
    return {"port": (capture["dense_base"], capture["compact_daily"]),
            "jax": (jax_capture["dense_base"], jax_capture["compact_daily"])}


PACKAGES = {"port": port_prepared, "jax": jax_prepared}


def _assert_slot_equal(got, want):
    (gb, gd), (wb, wd) = got, want
    assert list(gb.var_names) == list(wb.var_names)
    for name in ("values", "mask", "ids"):
        a, b = np.asarray(getattr(gb, name)), np.asarray(getattr(wb, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert np.asarray(gb.months).dtype == np.asarray(wb.months).dtype
    np.testing.assert_array_equal(gb.months, wb.months)
    for field in dataclasses.fields(wd):
        a, b = getattr(gd, field.name), getattr(wd, field.name)
        if isinstance(b, np.ndarray):
            assert np.asarray(a).dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("dtype", [np.float64, np.float32, torch.float32])
@pytest.mark.parametrize("salt", ["", "turnover=0", "turnover=1"])
def test_fingerprint_is_the_reference_packages(raw_dir, dtype, salt):
    jax_dtype = np.float32 if dtype is torch.float32 else dtype
    assert (port_prepared.raw_fingerprint(raw_dir, dtype, salt=salt)
            == jax_prepared.raw_fingerprint(raw_dir, jax_dtype, salt=salt))


def test_fingerprint_staleness_contract(raw_dir):
    fp = port_prepared.raw_fingerprint(raw_dir, np.float64)
    assert fp == port_prepared.raw_fingerprint(raw_dir, torch.float64)
    assert fp != port_prepared.raw_fingerprint(raw_dir, np.float32)
    assert fp != port_prepared.raw_fingerprint(raw_dir, np.float64, salt="turnover=1")
    victim = next(raw_dir.glob("*.parquet"))
    st = victim.stat()
    os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    try:
        assert fp != port_prepared.raw_fingerprint(raw_dir, np.float64)
    finally:
        os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert fp == port_prepared.raw_fingerprint(raw_dir, np.float64)


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_slot_written_by_one_package_loads_in_the_other(raw_dir, products, tmp_path,
                                                        writer, reader):
    fp = PACKAGES[writer].raw_fingerprint(raw_dir, np.float64, salt="turnover=0")
    assert fp == PACKAGES[reader].raw_fingerprint(raw_dir, np.float64, salt="turnover=0")
    PACKAGES[writer].save_prepared(tmp_path, fp, *products[writer])
    assert PACKAGES[reader].load_prepared(tmp_path, "another fingerprint") is None
    got = PACKAGES[reader].load_prepared(tmp_path, fp)
    assert got is not None
    assert isinstance(got[0].values, np.memmap) and not got[0].values.flags.writeable
    _assert_slot_equal(got, products[writer])
    # both packages' host products are the same arrays
    _assert_slot_equal(products["port"], products["jax"])


@pytest.mark.parametrize("damage, verify, message", [
    ("missing_payload", "0", "unreadable"),
    ("truncated_payload", "0", "bytes"),
    ("flipped_byte", "1", "sha256"),
])
def test_damaged_slot_is_a_warned_rebuild(raw_dir, products, tmp_path, monkeypatch,
                                          damage, verify, message):
    fp = port_prepared.raw_fingerprint(raw_dir, np.float64)
    port_prepared.save_prepared(tmp_path, fp, *products["port"])
    victim = tmp_path / ("daily.row_values.npy" if damage == "missing_payload"
                         else "base.values.npy")
    data = bytearray(victim.read_bytes())
    if damage == "missing_payload":
        victim.unlink()
    elif damage == "truncated_payload":
        victim.write_bytes(bytes(data[:-16]))
    else:
        data[-8] ^= 0xFF  # a payload byte; the size is unchanged
        victim.write_bytes(bytes(data))
        monkeypatch.setenv("FMRP_PREPARED_VERIFY", "0")
        assert port_prepared.load_prepared(tmp_path, fp) is not None  # the size check passes
    monkeypatch.setenv("FMRP_PREPARED_VERIFY", verify)
    with pytest.warns(UserWarning, match=message):
        assert port_prepared.load_prepared(tmp_path, fp) is None


def test_older_layout_is_a_miss_and_the_next_save_removes_it(raw_dir, products, tmp_path):
    stale = [tmp_path / "monthly_merged.parquet", tmp_path / "dense_base.npz"]
    for path in stale:
        path.write_bytes(b"stale payload")
    fp = port_prepared.raw_fingerprint(raw_dir, np.float64)
    (tmp_path / "meta.json").write_text(json.dumps({"fingerprint": fp, "version": 2}))
    assert port_prepared.load_prepared(tmp_path, fp) is None
    port_prepared.save_prepared(tmp_path, fp, *products["port"])
    assert not any(path.exists() for path in stale)
    assert port_prepared.load_prepared(tmp_path, fp) is not None


def _run(raw, **kw):
    return port_pipeline.run_pipeline(raw_data_dir=raw, device="cpu", dtype=torch.float64,
                                      make_figure=False, **kw)


def _assert_runs_bit_identical(a, b):
    assert torch.equal(torch.nan_to_num(a.panel.values, nan=7.0),
                       torch.nan_to_num(b.panel.values, nan=7.0))
    for name in ("table_1", "table_2", "decile_table"):
        assert getattr(a, name).equals(getattr(b, name)), name
    for leaf in ("coef", "slopes_bar", "intercept_bar", "x_lo", "x_hi", "gram", "n_obs"):
        np.testing.assert_array_equal(getattr(a.serving_state, leaf),
                                      getattr(b.serving_state, leaf), err_msg=leaf)


def test_warm_run_maps_the_slot_and_matches_the_cold_run(tmp_path, monkeypatch):
    monkeypatch.delenv("PREPARED_CACHE", raising=False)
    monkeypatch.delenv("FMRP_PANEL_ROUTE", raising=False)
    raw = tmp_path / "raw"
    write_synthetic_cache(raw, CFG)
    cold = _run(raw)
    assert {"load_prepared", "panel/monthly_ingest", "factors/daily_ingest",
            "build_panel/save_prepared"} <= set(cold.stage_seconds)
    slot = raw / port_prepared.PREPARED_DIRNAME
    meta = json.loads((slot / "meta.json").read_text())
    sizes = {p.name: p.stat().st_mtime_ns for p in slot.iterdir()}

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no write into, and no warning on, a read-only map
        warm = _run(raw)
    assert warm.timer.skipped == {"load_raw_data": "prepared checkpoint hit"}
    assert {"load_prepared", "build_panel", "factors/daily_kernels"} <= set(warm.stage_seconds)
    for stage in ("load_raw_data", "panel/monthly_ingest", "panel/universe_filter",
                  "factors/daily_ingest", "factors/long_to_dense",
                  "build_panel/save_prepared"):
        assert stage not in warm.stage_seconds, stage
    _assert_runs_bit_identical(warm, cold)
    assert {p.name: p.stat().st_mtime_ns for p in slot.iterdir()} == sizes
    assert meta == json.loads((slot / "meta.json").read_text())

    # a re-pulled raw file makes the slot stale: the next run rebuilds it
    victim = raw / "CRSP_stock_m.parquet"
    st = victim.stat()
    os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    rebuilt = _run(raw)
    assert "build_panel/save_prepared" in rebuilt.stage_seconds
    _assert_runs_bit_identical(rebuilt, cold)


def test_jax_warm_run_loads_the_slot_the_port_wrote(tmp_path, monkeypatch):
    monkeypatch.delenv("PREPARED_CACHE", raising=False)
    monkeypatch.setitem(jax_settings.d, "PREPARED_CACHE", 1)
    raw = tmp_path / "raw"
    write_synthetic_cache(raw, CFG)
    cold = _run(raw)
    jax = jax_run_pipeline(raw_data_dir=raw, dtype=np.float64, make_figure=False,
                           compile_pdf=False)
    assert "load_prepared" in jax.timer.durations
    assert jax.timer.skipped["load_raw_data"] == "prepared checkpoint hit"
    assert "build_panel/save_prepared" not in jax.timer.durations
    assert cold.table_2.equals(jax.table_2)


def test_prepared_cache_zero_disables_the_slot(tmp_path, monkeypatch):
    monkeypatch.setenv("PREPARED_CACHE", "0")
    raw = tmp_path / "raw"
    write_synthetic_cache(raw, SyntheticConfig(n_firms=20, n_months=36))
    for _ in range(2):
        res = _run(raw, make_deciles=False, make_serving=False)
        assert "panel/monthly_ingest" in res.stage_seconds
        assert "load_prepared" not in res.stage_seconds
        assert "build_panel/save_prepared" not in res.stage_seconds
    assert not (raw / port_prepared.PREPARED_DIRNAME).exists()
