"""The port's WRDS layer against ``tests/test_wrds_pull.py``'s ten cases:
the SQL builders give the reference package's strings for the same
arguments, the universe filter and the cache-hit paths select the same
rows, the pipeline applies the filter, and ``_wrds_query`` retries through
``resilience.retry`` against a stand-in ``wrds`` module (no network)."""

from __future__ import annotations

import sys
import types

import pandas as pd
import pytest

from fm_returnprediction_tpu.data import wrds_pull as jax_wrds
from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu_torch.data import wrds_pull
from fm_returnprediction_tpu_torch.data.wrds_pull import (
    build_compustat_sql,
    build_crsp_stock_sql,
    build_link_table_sql,
    pull_CRSP_index,
    pull_CRSP_stock,
    subset_to_common_stock_and_exchanges,
)

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def wrds():
    return generate_synthetic_wrds(SyntheticConfig(n_firms=30, n_months=24))


def test_universe_filter(wrds):
    out = subset_to_common_stock_and_exchanges(wrds["crsp_m"])
    assert len(out) > 0
    assert (out["securitysubtype"] == "COM").all()
    assert (out["usincflg"] == "Y").all()
    assert out["primaryexch"].isin(["N", "A", "Q"]).all()
    assert out["issuertype"].isin(["ACOR", "CORP"]).all()
    assert len(out) < len(wrds["crsp_m"])
    pd.testing.assert_frame_equal(
        out, jax_wrds.subset_to_common_stock_and_exchanges(wrds["crsp_m"]))


def test_universe_filter_categorical_and_columns(wrds):
    from fm_returnprediction_tpu_torch.data.wrds_pull import FLAG_COLUMNS, UNIVERSE_FLAGS

    assert FLAG_COLUMNS == jax_wrds.FLAG_COLUMNS and UNIVERSE_FLAGS == jax_wrds.UNIVERSE_FLAGS
    base = wrds["crsp_m"]
    want = subset_to_common_stock_and_exchanges(base)
    cat = base.copy()
    for c in FLAG_COLUMNS:
        cat[c] = cat[c].astype("category")
    got = subset_to_common_stock_and_exchanges(cat)
    assert len(got) == len(want)
    assert (got["permno"].to_numpy() == want["permno"].to_numpy()).all()
    pruned = subset_to_common_stock_and_exchanges(cat, columns=["permno", "mthcaldt", "retx"])
    assert list(pruned.columns) == ["permno", "mthcaldt", "retx"]
    pd.testing.assert_frame_equal(
        pruned, jax_wrds.subset_to_common_stock_and_exchanges(
            cat, columns=["permno", "mthcaldt", "retx"]))
    assert "ACOR" not in cat["issuertype"].cat.categories
    assert len(subset_to_common_stock_and_exchanges(cat)) == len(want)


@pytest.mark.parametrize("freq", ["M", "D"])
def test_crsp_sql_monthly_vs_daily(freq):
    sql = build_crsp_stock_sql(freq, "1964-01-01", "2013-12-31")
    assert sql == jax_wrds.build_crsp_stock_sql(freq, "1964-01-01", "2013-12-31")
    if freq == "M":
        assert "crsp.msf_v2" in sql and "mthret AS totret" in sql
        assert "mthcaldt >= '1964-01-01'" in sql
    else:
        assert "crsp.dsf_v2" in sql and "dlyretx AS retx" in sql
    with pytest.raises(ValueError):
        build_crsp_stock_sql("W", "a", "b")


def test_crsp_sql_filter_clause():
    args = ("M", "1964-01-01", "2013-12-31", "permno", ["10001", "10002"])
    sql = build_crsp_stock_sql(*args)
    assert "AND permno IN ('10001', '10002')" in sql
    assert sql == jax_wrds.build_crsp_stock_sql(*args)


def test_compustat_sql_standard_filters_and_gvkey_column():
    sql = build_compustat_sql("gvkey, datadate", "1964-01-01", "2013-12-31", gvkey="001234")
    for clause in ("indfmt='INDL'", "datafmt='STD'", "popsrc='D'", "consol='C'"):
        assert clause in sql
    assert "AND gvkey IN ('001234')" in sql
    assert sql == jax_wrds.build_compustat_sql("gvkey, datadate", "1964-01-01",
                                               "2013-12-31", gvkey="001234")
    assert (build_compustat_sql(wrds_pull.COMPUSTAT_DEFAULT_VARS, "a", "b", ["1", "2"])
            == jax_wrds.build_compustat_sql(jax_wrds.COMPUSTAT_DEFAULT_VARS, "a", "b",
                                            ["1", "2"]))


def test_link_table_sql():
    sql = build_link_table_sql()
    assert "substr(linktype,1,1)='L'" in sql
    assert "NOT IN ('LX', 'LD', 'LN')" in sql
    assert sql == jax_wrds.build_link_table_sql()
    assert build_link_table_sql(["001", "002"]) == jax_wrds.build_link_table_sql(["001", "002"])


def test_cache_hit_returns_filtered_universe(tmp_path, wrds):
    raw = wrds["crsp_m"]
    raw.to_parquet(tmp_path / "CRSP_stock_m.parquet", index=False)
    out = pull_CRSP_stock(freq="M", data_dir=tmp_path, file_name="CRSP_stock_m.parquet")
    want = subset_to_common_stock_and_exchanges(raw)
    assert len(out) == len(want)
    assert (out["securitysubtype"] == "COM").all()
    pd.testing.assert_frame_equal(out, jax_wrds.pull_CRSP_stock(
        freq="M", data_dir=tmp_path, file_name="CRSP_stock_m.parquet"))


def test_cache_hit_index_unfiltered(tmp_path, wrds):
    wrds["crsp_index_d"].to_parquet(tmp_path / "CRSP_index_d.parquet", index=False)
    out = pull_CRSP_index(freq="D", data_dir=tmp_path, file_name="CRSP_index_d.parquet")
    assert len(out) == len(wrds["crsp_index_d"])
    # a name without an extension finds the parquet through the candidates
    out2 = pull_CRSP_index(freq="D", data_dir=tmp_path, file_name="CRSP_index_d")
    pd.testing.assert_frame_equal(out, out2)


def test_pipeline_applies_universe_filter(wrds):
    from fm_returnprediction_tpu_torch.pipeline import build_panel

    panel, _ = build_panel(wrds, device="cpu")
    bad_permnos = set(wrds["crsp_m"].loc[wrds["crsp_m"]["usincflg"] != "Y", "permno"])
    assert not bad_permnos.intersection(panel.ids)


def _fake_wrds(monkeypatch, connection):
    fake = types.ModuleType("wrds")
    fake.Connection = connection
    monkeypatch.setitem(sys.modules, "wrds", fake)
    return fake


def test_wrds_query_retries_then_succeeds(monkeypatch):
    calls = {"n": 0}

    class FakeConn:
        def __init__(self, wrds_username=""):
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError(f"drop #{calls['n']}")

        def raw_sql(self, sql, date_cols=None):
            return pd.DataFrame({"x": [1]})

        def close(self):
            pass

    fake = _fake_wrds(monkeypatch, FakeConn)
    out = wrds_pull._wrds_query("SELECT 1", "u", [], retries=3, backoff_s=0.0)
    assert calls["n"] == 3 and len(out) == 1

    class AlwaysFail:
        def __init__(self, wrds_username=""):
            raise ConnectionError("down")

    fake.Connection = AlwaysFail
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        wrds_pull._wrds_query("SELECT 1", "u", [], retries=2, backoff_s=0.0)


def test_fresh_pulls_write_the_reference_caches(tmp_path, monkeypatch, wrds):
    """The four pullers through a stand-in connection: the same query
    strings, the same cache files and frames as the reference package's
    pullers, hashed and verbose cache names alike; the ``wrds.query``
    fault site fires before each connection attempt."""
    from fm_returnprediction_tpu_torch.resilience.faults import FaultPlan, FaultSpec

    seen = []

    class Answering:
        def __init__(self, wrds_username=""):
            pass

        def raw_sql(self, sql, date_cols=None):
            seen.append(sql)
            if "msf_v2" in sql:
                return wrds["crsp_m"].drop(columns=["jdate"], errors="ignore").copy()
            if "ccmxpf_linktable" in sql:
                return wrds["ccm"].copy()
            if "comp.funda" in sql:
                return wrds["comp"].copy()
            return wrds["crsp_index_d"].copy()

        def close(self):
            pass

    _fake_wrds(monkeypatch, Answering)
    kw = dict(start_date=pd.Timestamp("1964-01-01"), end_date="1966-12-31")
    for pkg, sub in ((wrds_pull, "port"), (jax_wrds, "jax")):
        d = tmp_path / sub
        pkg.pull_CRSP_stock(freq="M", data_dir=d, file_name="CRSP_stock_m.parquet", **kw)
        pkg.pull_CRSP_index(freq="D", data_dir=d, hash_file_name=True, **kw)
        pkg.pull_Compustat(data_dir=d, gvkey=["1", "2"], vars_str=["gvkey", "datadate"], **kw)
        pkg.pull_CRSP_Comp_link_table(data_dir=d, file_name="links", file_type="csv")
    half = len(seen) // 2
    assert seen[:half] == seen[half:]
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "links.csv" in port_files and len(port_files) == 4
    for name in port_files:
        a = wrds_pull.read_cached_data(tmp_path / "port" / name)
        b = jax_wrds.read_cached_data(tmp_path / "jax" / name)
        pd.testing.assert_frame_equal(a, b)
    with FaultPlan({"wrds.query": FaultSpec(times=1, exc=ConnectionError)}) as plan:
        wrds_pull._wrds_query("SELECT 1", "u", [], retries=1, backoff_s=0.0)
    assert plan.fired["wrds.query"] == 1
