"""The port's columnar ingest route vs its legacy route and the JAX package's.

One raw parquet directory (``write_synthetic_cache``, seeded) goes through

- the port's columnar route (``panel.columnar``: chunked Arrow reads, numpy
  joins, the dense scatter and the daily strips from filtered batches);
- the port's legacy route (``pipeline.build_panel`` on the pandas frames,
  its host products captured);
- the JAX package's columnar route (``fm_returnprediction_tpu.panel.columnar``).

The dense base panels (values, mask, months, ids, names) and the compact
daily strips are bit-equal across the three at float64 and float32, also on
the edge cases of ``tests/test_panel_columnar.py`` (thin months, an all-NaN
fundamental column, several CCM links per permno and several securities per
permco with an exact market-equity tie). Through ``run_pipeline`` on the
CPU the port's columnar run matches the JAX columnar run at the tolerances
of ``tests/test_torch_pipeline.py``: the enriched panel at rtol 1e-10 with
identical NaN patterns, Table 2's formatted frame equal, Table 1 at rtol
1e-10 with N exact. The route knob, the fallback warning, the typed
missing-column error and the read-ahead queue's behaviours are pinned too.
"""

import dataclasses
import time

import numpy as np
import pandas as pd
import pytest
import torch

from fm_returnprediction_tpu import settings as jax_settings
from fm_returnprediction_tpu.panel import columnar as jax_columnar
from fm_returnprediction_tpu.pipeline import run_pipeline as jax_run_pipeline
from fm_returnprediction_tpu_torch import pipeline as port_pipeline
from fm_returnprediction_tpu_torch.data.columnar import (
    ColumnarIngestError,
    _prefetched,
    read_filtered_columns,
    resolve_prefetch_depth,
)
from fm_returnprediction_tpu_torch.data.synthetic import (
    FILE_NAMES,
    SyntheticConfig,
    write_synthetic_cache,
)
from fm_returnprediction_tpu_torch.panel import columnar as port_columnar

pytestmark = pytest.mark.torch_port

CFG = SyntheticConfig(n_firms=40, n_months=60)
DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw_columnar")
    write_synthetic_cache(d, CFG)
    return d


def _thin(raw):
    write_synthetic_cache(raw, SyntheticConfig(n_firms=6, n_months=30))


def _all_nan_dvc(raw):
    write_synthetic_cache(raw, SyntheticConfig(n_firms=25, n_months=36))
    comp = pd.read_parquet(raw / FILE_NAMES["comp"])
    comp["dvc"] = np.nan
    comp.to_parquet(raw / FILE_NAMES["comp"], index=False)


def _multilink_multisecurity(raw):
    """Two extra open CCM links (below and above the original gvkey) and
    three clones of one permco's securities, the last an exact ME tie."""
    write_synthetic_cache(raw, SyntheticConfig(n_firms=30, n_months=36))
    ccm = pd.read_parquet(raw / FILE_NAMES["ccm"]).sort_values("gvkey").reset_index(drop=True)
    wide_lo = ccm.iloc[[0]].assign(permno=ccm["permno"].iloc[-1])
    wide_hi = ccm.iloc[[-1]].assign(permno=ccm["permno"].iloc[0])
    for extra in (wide_lo, wide_hi):
        extra["linkdt"] = pd.Timestamp("1960-01-31")
        extra["linkenddt"] = pd.NaT
    pd.concat([ccm, wide_lo, wide_hi]).to_parquet(raw / FILE_NAMES["ccm"], index=False)
    m = pd.read_parquet(raw / FILE_NAMES["crsp_m"])
    block = m[m["permco"] == m["permco"].iloc[0]]
    clones = []
    for i, scale in enumerate((0.31, 0.57, 1.0)):
        c = block.copy()
        c["permno"] = c["permno"] + 90_000 + i
        c["prc"] = c["prc"] * scale
        clones.append(c)
    pd.concat([m, *clones]).to_parquet(raw / FILE_NAMES["crsp_m"], index=False)


EDGE_CASES = {"thin_months": _thin, "all_nan_column": _all_nan_dvc,
              "multilink_multisecurity": _multilink_multisecurity}


def _assert_base_equal(got, want):
    assert list(got.var_names) == list(want.var_names)
    np.testing.assert_array_equal(np.asarray(got.months).astype("datetime64[ns]"),
                                  np.asarray(want.months).astype("datetime64[ns]"))
    np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids))
    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(want.mask))
    g, w = np.asarray(got.values), np.asarray(want.values)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w, equal_nan=True), "base panel values differ"


def _assert_daily_equal(got, want):
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            if b.dtype.kind == "M":
                a, b = a.astype("datetime64[s]"), b.astype("datetime64[s]")
            assert np.asarray(a).dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


def _three_routes(raw, np_dtype, torch_dtype):
    """(port columnar, port legacy, JAX columnar) as (base, daily) pairs."""
    base = port_columnar.build_dense_base_columnar(raw, dtype=np_dtype)
    daily = port_columnar.ingest_compact_daily_columnar(raw, base.months, dtype=np_dtype)
    capture = {}
    port_pipeline.build_panel(port_pipeline.load_raw_data(raw), dtype=torch_dtype,
                              device="cpu", capture=capture)
    jax_base = jax_columnar.build_dense_base_columnar(raw, dtype=np_dtype)
    jax_daily = jax_columnar.ingest_compact_daily_columnar(raw, jax_base.months,
                                                           dtype=np_dtype)
    return ((base, daily), (capture["dense_base"], capture["compact_daily"]),
            (jax_base, jax_daily))


@pytest.mark.parametrize("np_dtype, torch_dtype", DTYPES)
def test_base_panel_and_daily_bit_equal_across_routes(raw_dir, np_dtype, torch_dtype):
    (base, daily), legacy, jax = _three_routes(raw_dir, np_dtype, torch_dtype)
    assert np.asarray(base.values).dtype == np_dtype
    for other_base, other_daily in (legacy, jax):
        _assert_base_equal(base, other_base)
        _assert_daily_equal(daily, other_daily)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases_bit_equal_across_routes(tmp_path, case):
    raw = tmp_path / case
    EDGE_CASES[case](raw)
    (base, daily), legacy, jax = _three_routes(raw, np.float64, torch.float64)
    if case == "all_nan_column":
        assert np.isnan(np.asarray(base.var("dvc"))).all()
    for other_base, other_daily in (legacy, jax):
        _assert_base_equal(base, other_base)
        _assert_daily_equal(daily, other_daily)


def test_columnar_run_matches_jax_columnar_run(raw_dir, monkeypatch):
    """The enriched panel, Table 1 and Table 2 of a cold columnar run in
    each package (no prepared slot on either side)."""
    monkeypatch.setenv("PREPARED_CACHE", "0")
    monkeypatch.setitem(jax_settings.d, "PREPARED_CACHE", 0)
    monkeypatch.delenv("FMRP_PANEL_ROUTE", raising=False)
    port = port_pipeline.run_pipeline(raw_data_dir=raw_dir, device="cpu",
                                      dtype=torch.float64, make_figure=False)
    jax = jax_run_pipeline(raw_data_dir=raw_dir, dtype=np.float64, make_figure=False,
                           compile_pdf=False)
    assert "panel/monthly_ingest" in port.stage_seconds
    assert "panel/monthly_ingest" in jax.timer.durations
    assert port.timer.skipped["load_raw_data"] == jax.timer.skipped["load_raw_data"]
    assert port.panel.var_names == jax.panel.var_names
    g, w = port.panel.values.numpy(), np.asarray(jax.panel.values)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=1e-10, atol=0, equal_nan=True)
    assert port.table_2.equals(jax.table_2)
    n_cols = [c for c in jax.table_1.columns if c[1] == "N"]
    np.testing.assert_array_equal(port.table_1[n_cols].to_numpy(),
                                  jax.table_1[n_cols].to_numpy())
    np.testing.assert_allclose(port.table_1.drop(columns=n_cols).to_numpy(float),
                               jax.table_1.drop(columns=n_cols).to_numpy(float),
                               rtol=1e-10, atol=0, equal_nan=True)


@pytest.mark.parametrize("value, want", [
    ("columnar", "columnar"), ("legacy", "legacy"), (" Legacy ", "legacy"),
    (None, "columnar"), ("parquet-ish", ValueError)])
def test_route_knob(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("FMRP_PANEL_ROUTE", raising=False)
    else:
        monkeypatch.setenv("FMRP_PANEL_ROUTE", value)
    if want is ValueError:
        with pytest.raises(ValueError, match="FMRP_PANEL_ROUTE"):
            port_pipeline.panel_route()
    else:
        assert port_pipeline.panel_route() == want


def test_columnar_failure_falls_back_to_legacy(raw_dir, monkeypatch):
    """A cache the columnar reader cannot service goes through the legacy
    route with a warning, and the run completes."""
    monkeypatch.setenv("PREPARED_CACHE", "0")
    monkeypatch.delenv("FMRP_PANEL_ROUTE", raising=False)

    def unserviceable(*a, **k):
        raise ColumnarIngestError("synthetic unserviceable cache")

    monkeypatch.setattr(port_pipeline, "build_panel_columnar", unserviceable)
    timer = port_pipeline.StageTimer(torch.device("cpu"))
    with pytest.warns(UserWarning, match="falling back to the legacy"):
        panel, _ = port_pipeline.load_or_build_panel(raw_dir, dtype=torch.float64,
                                                     device="cpu", timer=timer)
    assert "rolling_std_252" in panel.var_names
    assert "load_raw_data" in timer.durations and "load_raw_data" not in timer.skipped


@pytest.mark.parametrize("file_key, column", [("crsp_m", "sharetype"), ("crsp_d", "retx"),
                                              ("ccm", "linkdt")])
def test_missing_column_is_a_typed_ingest_error(tmp_path, file_key, column):
    raw = tmp_path / "nocol"
    write_synthetic_cache(raw, SyntheticConfig(n_firms=10, n_months=12))
    path = raw / FILE_NAMES[file_key]
    pd.read_parquet(path).drop(columns=[column]).to_parquet(path, index=False)
    with pytest.raises(ColumnarIngestError, match=column):
        port_columnar.build_panel_columnar(raw, dtype=torch.float64, device="cpu")


# -- the read-ahead queue ----------------------------------------------------


def test_prefetch_depth_resolution(monkeypatch):
    monkeypatch.delenv("FMRP_INGEST_PREFETCH", raising=False)
    assert resolve_prefetch_depth() == 2
    for raw, want in (("0", 0), ("5", 5), ("nope", 0)):
        monkeypatch.setenv("FMRP_INGEST_PREFETCH", raw)
        assert resolve_prefetch_depth() == want
    assert resolve_prefetch_depth(3) == 3      # the argument beats the variable
    assert resolve_prefetch_depth(-1) == 0


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order(depth):
    items = list(range(57))
    assert list(_prefetched(iter(items), depth)) == items
    assert list(_prefetched(iter([]), depth)) == []


def test_prefetch_reader_exception_reaches_consumer():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("disk gone")

    out = []
    with pytest.raises(RuntimeError, match="disk gone"):
        for v in _prefetched(gen(), 2):
            out.append(v)
    assert out == [1, 2]


@pytest.mark.parametrize("n_items", [3, 10_000])
def test_prefetch_early_consumer_exit_stops_reader(n_items):
    """The consumer leaves after two items: the reader stops within the
    queue's depth, also when the source ends while the queue is full."""
    produced = []

    def gen():
        for i in range(n_items):
            produced.append(i)
            yield i

    it = _prefetched(gen(), 2)
    got = [next(it), next(it)]
    start = time.perf_counter()
    it.close()
    assert time.perf_counter() - start < 1.0   # the reader did not block close()
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n and n <= 2 + 2 + 2
    assert got == [0, 1]


def test_filtered_read_serial_prefetched_and_jax_agree(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from fm_returnprediction_tpu.data.columnar import (
        read_filtered_columns as jax_read_filtered_columns,
    )

    rng = np.random.default_rng(0)
    n = 10_000
    flags = rng.choice(["10", "11", "20"], n)
    exch = rng.choice(["N", "A", "Q"], n)
    table = pa.table({
        "shrcd": pa.array(flags).dictionary_encode(),
        "exchcd": pa.array(exch).dictionary_encode(),
        "ret": rng.standard_normal(n),
        "permno": rng.integers(1, 500, n),
    })
    path = tmp_path / "strip.parquet"
    pq.write_table(table, path)
    kw = dict(value_columns=["ret", "permno"],
              flag_spec={"shrcd": ["10", "11"], "exchcd": ["N", "A", "Q"]},
              bool_columns={"exchcd": ["N"]}, batch_rows=700)
    serial = read_filtered_columns(path, prefetch=0, **kw)
    keep = np.isin(flags, ["10", "11"])
    np.testing.assert_array_equal(serial["ret"], np.asarray(table["ret"])[keep])
    np.testing.assert_array_equal(serial["exchcd"], exch[keep] == "N")
    for other in (read_filtered_columns(path, prefetch=3, **kw),
                  jax_read_filtered_columns(path, prefetch=0, **kw)):
        assert other.keys() == serial.keys()
        for k in serial:
            np.testing.assert_array_equal(other[k], serial[k], err_msg=k)


@pytest.mark.parametrize("encoding", ["dictionary", "string", "large_string", "string with nulls",
                                      "int64"])
def test_flag_keep_mask_matches_series_isin(encoding):
    import pyarrow as pa

    from fm_returnprediction_tpu_torch.data.columnar import _flag_keep_mask

    rng = np.random.default_rng(1)
    n = 5_000
    values = rng.choice(["RW", "A", "NS", "EQTY"], n).astype(object)
    wanted = ("RW", "NS")
    if encoding == "string with nulls":
        values[rng.random(n) < 0.1] = None
    if encoding == "int64":
        values = rng.integers(0, 5, n)
        wanted = (1, 3)
        col = pa.array(values)
    elif encoding == "dictionary":
        col = pa.array(values, type=pa.string()).dictionary_encode()
    else:
        col = pa.array(values, type=pa.large_string() if encoding == "large_string"
                       else pa.string())
    expected = pd.Series(values).isin(list(wanted)).to_numpy()
    keep = _flag_keep_mask({"flag": pa.chunked_array([col[:1234], col[1234:]])},
                           {"flag": wanted})
    assert keep.dtype == bool
    np.testing.assert_array_equal(keep, expected)
    if encoding == "int64":
        with pytest.raises(ColumnarIngestError, match="cannot hold"):
            _flag_keep_mask({"flag": col}, {"flag": ("RW",)})
