"""The port's host helpers (``utils.frames``, ``utils.figures``) and the
published-oracle module against ``tests/test_frames_published.py``'s nine
cases: each case runs the reference package's function and the port's on
the same inputs and holds the outputs equal, besides the reference test's
own assertions."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from fm_returnprediction_tpu.reporting import published as jax_published
from fm_returnprediction_tpu.utils import frames as jax_frames
from fm_returnprediction_tpu_torch.reporting.published import (
    PUBLISHED_TABLE_1,
    compare_table_1,
    published_table_1,
)
from fm_returnprediction_tpu_torch.utils.frames import (
    filter_columns_and_indexes,
    fix_dates_index,
    time_series_to_df,
)

pytestmark = pytest.mark.torch_port


def _same(got, want):
    if isinstance(got, pd.Series):
        pd.testing.assert_series_equal(got, want)
    else:
        pd.testing.assert_frame_equal(got, want)


# -- frames ---------------------------------------------------------------

def test_time_series_to_df_variants():
    s1 = pd.Series([1, 2], index=[0, 1], name="a")
    s2 = pd.Series([3.0, 4.0], index=[1, 2], name="b")
    df = time_series_to_df([s1, s2])
    assert list(df.columns) == ["a", "b"]
    assert len(df) == 3 and np.isnan(df.loc[0, "b"])
    assert time_series_to_df(s1).shape == (2, 1)
    pd.testing.assert_frame_equal(time_series_to_df(df), df)
    for arg in ([s1, s2], s1, df):
        _same(time_series_to_df(arg), jax_frames.time_series_to_df(arg))
    with pytest.raises(TypeError):
        time_series_to_df([s1, "not-a-series"])
    with pytest.raises(TypeError):
        time_series_to_df(42)


def test_fix_dates_index_promotes_date_column():
    df = pd.DataFrame({"Date": ["2020-01-31", "2020-02-29"], "x": ["1", "2"]})
    out = fix_dates_index(df)
    assert out.index.name == "date"
    assert isinstance(out.index, pd.DatetimeIndex)
    assert out["x"].dtype == float
    _same(out, jax_frames.fix_dates_index(df))


def test_fix_dates_index_existing_datetime_index():
    idx = pd.to_datetime(["2020-01-31", "2020-02-29"])
    df = pd.DataFrame({"x": [1, 2]}, index=idx)
    out = fix_dates_index(df)
    assert out.index.name == "date"
    _same(out, jax_frames.fix_dates_index(df))


def test_filter_columns_and_indexes():
    df = pd.DataFrame(
        np.arange(12).reshape(3, 4),
        columns=["alpha", "beta", "gamma", "Beta2"],
        index=["row_a", "row_b", "other"],
    )
    kept = filter_columns_and_indexes(df, keep_columns=["beta"])
    assert list(kept.columns) == ["beta", "Beta2"]  # case-insensitive substring
    dropped = filter_columns_and_indexes(df, drop_columns=["beta"])
    assert list(dropped.columns) == ["alpha", "gamma"]
    kept_rows = filter_columns_and_indexes(df, keep_indexes=["row"])
    assert list(kept_rows.index) == ["row_a", "row_b"]
    dropped_rows = filter_columns_and_indexes(df, drop_indexes=["row"])
    assert list(dropped_rows.index) == ["other"]
    assert filter_columns_and_indexes("not a frame") == "not a frame"
    for kw in ({"keep_columns": ["beta"]}, {"drop_columns": "beta"},
               {"keep_indexes": ["row"]}, {"drop_indexes": ["row"]},
               {"keep_columns": ["a"], "drop_columns": ["beta"]}):
        _same(filter_columns_and_indexes(df, **kw),
              jax_frames.filter_columns_and_indexes(df, **kw))


def test_filter_series_input():
    s = pd.Series([1, 2, 3], index=["alpha", "beta", "gamma"])
    out = filter_columns_and_indexes(s, drop_columns=["alp"])
    pd.testing.assert_series_equal(out, s)
    out = filter_columns_and_indexes(s, drop_indexes=["alp"])
    assert list(out.index) == ["beta", "gamma"]
    _same(out, jax_frames.filter_columns_and_indexes(s, drop_indexes=["alp"]))


def test_save_figure_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from fm_returnprediction_tpu_torch.utils.figures import save_figure

    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    path = save_figure(fig, "line", tmp_path / "figs", dpi=50)
    plt.close(fig)
    assert path == tmp_path / "figs" / "line.png"
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# -- published oracle -----------------------------------------------------

def test_published_layout_matches_reference_contract():
    t = published_table_1()
    assert t.shape == (16, 9)
    assert list(t.index[:4]) == [
        "Return (%)", "LogSize_{-1}", "LogB/M_{-1}", "Return_{-2,-12}",
    ]
    assert t.columns.names == ["Subset", "Statistic"]
    assert float(t.loc["Return (%)", ("All stocks", "Avg")]) == 1.27
    assert float(t.loc["Sales/Price_{yr-1}", ("Large stocks", "N")]) == 865
    pd.testing.assert_frame_equal(t, jax_published.published_table_1())
    assert PUBLISHED_TABLE_1 == jax_published.PUBLISHED_TABLE_1


def test_published_computed_scope_excludes_turnover():
    t = published_table_1(computed_only=True)
    assert t.shape == (15, 9)
    assert "Turnover_{-1,-12}" not in t.index
    assert not PUBLISHED_TABLE_1["Turnover_{-1,-12}"][0]
    pd.testing.assert_frame_equal(t, jax_published.published_table_1(computed_only=True))


def test_compare_table_1_detects_mismatch():
    oracle = published_table_1(computed_only=True)
    diff = compare_table_1(oracle)
    assert len(diff) == 15 * 9 and diff["ok"].all()

    perturbed = oracle.copy()
    perturbed.loc["ROA_{yr-1}", ("All stocks", "Avg")] += 1.0
    diff = compare_table_1(perturbed)
    bad = diff[~diff["ok"]]
    assert len(bad) == 1
    assert bad.iloc[0]["variable"] == "ROA_{yr-1}" and bad.iloc[0]["stat"] == "Avg"
    pd.testing.assert_frame_equal(diff, jax_published.compare_table_1(perturbed))


def test_compare_table_1_label_map_and_missing_rows():
    from fm_returnprediction_tpu_torch.reporting.published import PARITY_LABEL_MAP

    oracle = published_table_1(computed_only=True)
    renamed = oracle.rename(index={"ROA_{yr-1}": "ROA (-1)"})
    diff = compare_table_1(renamed, label_map={"ROA (-1)": "ROA_{yr-1}"})
    assert set(diff["variable"]) == set(oracle.index)
    partial = oracle.iloc[:3]
    diff = compare_table_1(partial)
    assert set(diff["variable"]) == set(oracle.index[:3])
    pd.testing.assert_frame_equal(diff, jax_published.compare_table_1(partial))
    assert PARITY_LABEL_MAP == jax_published.PARITY_LABEL_MAP


def test_parity_entry_without_a_real_cache(tmp_path, capsys):
    """``real_cache_present`` and the command line's exit 2 on a directory
    without the five files, and on a synthetic-backed one."""
    from fm_returnprediction_tpu_torch.data.synthetic import (
        SyntheticConfig,
        write_synthetic_cache,
    )
    from fm_returnprediction_tpu_torch.reporting.published import _main, real_cache_present

    assert not real_cache_present(tmp_path)
    assert _main([str(tmp_path), "--device", "cpu"]) == 2
    write_synthetic_cache(tmp_path, SyntheticConfig(n_firms=8, n_months=6))
    assert real_cache_present(tmp_path) == jax_published.real_cache_present(tmp_path) is True
    (tmp_path / "_data_backend.txt").write_text("synthetic")
    assert not real_cache_present(tmp_path)
    assert not jax_published.real_cache_present(tmp_path)
    assert "No real WRDS cache" in capsys.readouterr().out
