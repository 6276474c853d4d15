"""The dense daily route, the port vs the JAX package.

``panel.daily.build_daily_panel`` packs the same daily frames into the same
(D, N) grid and calendar vectors (every field equal). The port's
``ops.daily_chunked.daily_characteristics_chunked`` runs vol-252 and the
weekly beta on that grid in firm strips; at float64 on the CPU it is held:

- against the JAX function on the same arrays at 1e-12, for the auto width
  (one call), widths 10 and 37, and strips forced by
  ``FMRP_DAILY_BUDGET_BYTES=200000`` (three strips of a 300-firm grid);
- bit for bit against the port's own compact route
  (``daily_characteristics_compact_chunked``) on the same rows, and the
  strips bit for bit against the single call;
- ``auto_firm_chunk`` against the JAX function for the same budgets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.data.synthetic import SyntheticConfig, generate_synthetic_wrds
from fm_returnprediction_tpu.ops import daily_chunked as jax_chunked
from fm_returnprediction_tpu.panel.daily import build_daily_panel as jax_build_daily_panel
from fm_returnprediction_tpu_torch.ops import daily_chunked
from fm_returnprediction_tpu_torch.panel.daily import (
    DailyPanel,
    build_compact_daily,
    build_daily_panel,
)

pytestmark = pytest.mark.torch_port

KW = dict(window=60, min_periods=20, window_weeks=26)
BUDGET = 200_000  # bytes: 128-firm strips of a 240-day float64 grid


def _fixture(seed: int, d: int = 240, n: int = 37, n_months: int = 12) -> dict:
    rng = np.random.default_rng(seed)
    ret = rng.standard_normal((d, n)) * 0.02
    mask = rng.random((d, n)) > 0.25
    ret = np.where(rng.random((d, n)) > 0.05, ret, np.nan)  # nulls inside rows
    mkt = rng.standard_normal(d) * 0.01
    mkt_present = rng.random(d) > 0.03
    mkt = np.where(mkt_present, mkt, np.nan)
    month_id = np.repeat(np.arange(n_months), d // n_months).astype(np.int32)
    week_id = (np.arange(d) // 5).astype(np.int32)
    n_weeks = int(week_id.max()) + 1
    week_month_id = np.clip(np.arange(n_weeks) // 4, 0, n_months - 1).astype(np.int32)
    return dict(ret_d=ret, mask_d=mask, mkt_d=mkt, month_id=month_id, week_id=week_id,
                week_month_id=week_month_id, n_months=n_months, n_weeks=n_weeks,
                mkt_present=mkt_present)


def _to_csr(d: dict) -> dict:
    """The dense fixture's present rows in the compacted layout."""
    mask = d["mask_d"]
    n_days, n_firms = mask.shape
    values, pos, offsets = [], [], [0]
    for f in range(n_firms):
        rows = np.nonzero(mask[:, f])[0]
        values.append(d["ret_d"][rows, f])
        pos.append(rows)
        offsets.append(offsets[-1] + len(rows))
    return dict(row_values=np.concatenate(values), row_pos=np.concatenate(pos).astype(np.int16),
                offsets=np.asarray(offsets, dtype=np.int64), mkt_d=d["mkt_d"],
                mkt_present=d["mkt_present"], day_month_id=d["month_id"],
                week_id=d["week_id"], week_month_id=d["week_month_id"], n_days=n_days,
                n_weeks=d["n_weeks"], n_months=d["n_months"])


@pytest.fixture(scope="module")
def frames():
    data = generate_synthetic_wrds(SyntheticConfig(n_firms=25, n_months=30))
    months = np.sort(data["crsp_m"]["jdate"].unique())
    # one firm-day absent from the index table: its market return is NaN
    index_d = data["crsp_index_d"].iloc[1:]
    return data["crsp_d"], index_d, months


def test_build_daily_panel_matches_reference(frames):
    crsp_d, index_d, months = frames
    got = build_daily_panel(crsp_d, index_d, months)
    want = jax_build_daily_panel(crsp_d, index_d, months)
    assert isinstance(got, DailyPanel)
    assert not got.mkt_present[0] and np.isnan(got.mkt[0])
    for field in ("ret", "mask", "mkt", "mkt_present", "days", "ids", "day_month_id",
                  "week_id", "week_month_id"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.n_weeks, got.n_months) == (want.n_weeks, want.n_months)


def test_dense_and_compact_layouts_agree(frames):
    crsp_d, index_d, months = frames
    dense = build_daily_panel(crsp_d, index_d, months)
    compact = build_compact_daily(crsp_d, index_d, months)
    np.testing.assert_array_equal(dense.ids, compact.ids)
    np.testing.assert_array_equal(dense.days, compact.days)
    rebuilt = np.full_like(dense.ret, np.nan)
    for f in range(len(compact.ids)):
        a, b = compact.offsets[f], compact.offsets[f + 1]
        rebuilt[compact.row_pos[a:b].astype(np.int64), f] = compact.row_values[a:b]
    np.testing.assert_array_equal(np.where(dense.mask, dense.ret, np.nan), rebuilt)


def test_daily_panel_refuses_decreasing_weeks(frames):
    """A ``DailyPanel`` whose week ids run backwards is taken as the
    reference takes it: the dense route on it equals the JAX function's on
    the same arrays at 1e-12."""
    crsp_d, index_d, months = frames
    panel = build_daily_panel(crsp_d, index_d, months)
    fields = {k: getattr(panel, k) for k in panel.__dataclass_fields__}
    fields["week_id"] = panel.week_id[::-1].copy()
    back = DailyPanel(**fields)
    d = dict(ret_d=back.ret, mask_d=back.mask, mkt_d=back.mkt, month_id=back.day_month_id,
             week_id=back.week_id, week_month_id=back.week_month_id,
             n_months=back.n_months, n_weeks=back.n_weeks, mkt_present=back.mkt_present)
    vol, beta = daily_chunked.daily_characteristics_chunked(**d, **KW, device="cpu")
    want_vol, want_beta = _reference(d)
    np.testing.assert_allclose(vol, want_vol, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(beta, want_beta, rtol=1e-12, atol=1e-15)


def _reference(d: dict, firm_chunk=None):
    vol, beta = jax_chunked.daily_characteristics_chunked(**d, **KW, firm_chunk=firm_chunk)
    return np.asarray(vol), np.asarray(beta)


def _compact(d: dict):
    return daily_chunked.daily_characteristics_compact_chunked(
        **_to_csr(d), **KW, device="cpu", dtype=torch.float64, firm_chunk=16,
        height_bucket=64)


@pytest.mark.parametrize("n_firms, firm_chunk", [(37, None), (37, 10), (37, 37),
                                                 (300, "budget")])
def test_dense_route_matches_reference_and_compact_route(monkeypatch, n_firms, firm_chunk):
    d = _fixture(7, n=n_firms)
    if firm_chunk == "budget":
        monkeypatch.setenv("FMRP_DAILY_BUDGET_BYTES", str(BUDGET))
        firm_chunk = None
        assert daily_chunked.auto_firm_chunk(240, n_firms, 8, device="cpu") == 128
    vol, beta = daily_chunked.daily_characteristics_chunked(**d, **KW, firm_chunk=firm_chunk,
                                                            device="cpu")
    assert vol.shape == beta.shape == (d["n_months"], n_firms)
    assert vol.dtype == beta.dtype == np.float64
    want_vol, want_beta = _reference(d, firm_chunk)
    np.testing.assert_allclose(vol, want_vol, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(beta, want_beta, rtol=1e-12, atol=1e-15)
    assert np.isfinite(vol).any() and np.isfinite(beta).any()
    got_vol, got_beta = _compact(d)
    np.testing.assert_array_equal(vol, got_vol)
    np.testing.assert_array_equal(beta, got_beta)
    one_vol, one_beta = daily_chunked.daily_characteristics_chunked(
        **d, **KW, firm_chunk=n_firms, device="cpu")
    np.testing.assert_array_equal(vol, one_vol)
    np.testing.assert_array_equal(beta, one_beta)


@pytest.mark.parametrize("n_days, n_firms, itemsize, budget", [
    (240, 37, 8, 1 << 30), (12608, 25000, 4, int(9.6e9)), (12608, 25000, 8, 1),
    (240, 300, 8, BUDGET), (12600, 22000, 4, int(0.6 * 80e9)), (12600, 22000, 4, 3 << 30)])
def test_auto_firm_chunk_matches_reference(n_days, n_firms, itemsize, budget):
    got = daily_chunked.auto_firm_chunk(n_days, n_firms, itemsize, budget_bytes=budget)
    assert got == jax_chunked.auto_firm_chunk(n_days, n_firms, itemsize, budget_bytes=budget)
    assert got is None or (got % 128 == 0 or got == n_firms)


def test_default_budget(monkeypatch):
    monkeypatch.delenv("FMRP_DAILY_BUDGET_BYTES", raising=False)
    assert daily_chunked._default_budget_bytes("cpu") == 4 << 30
    monkeypatch.setenv("FMRP_DAILY_BUDGET_BYTES", "12345")
    assert daily_chunked._default_budget_bytes("cpu") == 12345
    # the whole real-size grid fits 60% of an 80 GB card: one call
    assert daily_chunked.auto_firm_chunk(12600, 22000, 4, budget_bytes=int(0.6 * 80e9)) is None


def test_dense_route_refuses_bad_week_ids():
    """Week ids in any order, and ids past ``n_weeks`` (their days dropped
    from the weekly sums, as the reference's ``segment_sum`` drops them):
    the dense route and the compact route equal the JAX function at 1e-12."""
    d = _fixture(8)
    rng = np.random.default_rng(8)
    cases = {"shuffled": dict(d, week_id=rng.permutation(d["week_id"])),
             "out of range": dict(d, n_weeks=d["n_weeks"] - 1,
                                  week_month_id=d["week_month_id"][:-1])}
    for name, case in cases.items():
        vol, beta = daily_chunked.daily_characteristics_chunked(**case, **KW, device="cpu")
        want_vol, want_beta = _reference(case)
        np.testing.assert_allclose(vol, want_vol, rtol=1e-12, atol=1e-15, err_msg=name)
        np.testing.assert_allclose(beta, want_beta, rtol=1e-12, atol=1e-15, err_msg=name)
        assert np.isfinite(beta).any(), name
        got_vol, got_beta = _compact(case)
        np.testing.assert_allclose(got_vol, want_vol, rtol=1e-12, atol=1e-15, err_msg=name)
        np.testing.assert_allclose(got_beta, want_beta, rtol=1e-12, atol=1e-15, err_msg=name)


def test_dense_route_float32_matches_reference():
    d = _fixture(9)
    d32 = dict(d, ret_d=d["ret_d"].astype(np.float32), mkt_d=d["mkt_d"].astype(np.float32))
    vol, beta = daily_chunked.daily_characteristics_chunked(**d32, **KW, firm_chunk=10,
                                                            device="cpu")
    assert vol.dtype == np.float32
    want_vol, want_beta = (np.asarray(a) for a in jax_chunked.daily_characteristics_chunked(
        **{k: (jnp.asarray(v) if k in ("ret_d", "mkt_d") else v) for k, v in d32.items()},
        **KW, firm_chunk=10))
    np.testing.assert_allclose(vol, want_vol, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(beta, want_beta, rtol=1e-3, atol=1e-5)
