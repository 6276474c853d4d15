"""The in-memory Gram bank, the port vs the JAX package on the CPU.

The JAX package's own fixtures (``tests/test_grambank.py``: 30 months × 140
firms × 4 columns, 2 sets × 2 universes, float64) go through both
packages' ``build_bank`` and queries. Compared:

- the banked leaves at the tolerance of the contraction parity tests
  (``tests/test_torch_grams.py``: each (pair, month) block at 1e-12 of its
  largest entry, counts exact, the center at rtol 1e-13);
- ``window_query`` at the reference's pins against its grid route (1e-12,
  t-stats 1e-10), counts and month gates exact;
- ``bootstrap_query`` on the same draw rows at 1e-12;
- ``ingest_month`` additivity at the reference's pins (leaves at 1e-13 of
  the largest entry, the grown bank's query at 1e-11), and against the JAX
  package's own grown bank;
- ``run_scenarios_banked`` against the port's ``run_scenarios`` at 1e-9 (the
  reference's pin), and against the JAX package's banked frame;
- ``bootstrap_aggregate_pairs`` equal, row by row, to
  ``bootstrap_aggregate_device``; the default device of both is the GPU.
"""

import numpy as np
import pytest
import torch

from fm_returnprediction_tpu.models.lewellen import ModelSpec as JaxModelSpec
from fm_returnprediction_tpu.specgrid import grambank as jax_grambank
from fm_returnprediction_tpu.specgrid import scenarios as jax_scenarios
from fm_returnprediction_tpu.specgrid.boot import fm_aggregate_np
from fm_returnprediction_tpu.specgrid.cellspace import CellSpace as JaxCellSpace
from fm_returnprediction_tpu_torch.models.lewellen import ModelSpec
from fm_returnprediction_tpu_torch.specgrid import boot, grambank, scenarios
from fm_returnprediction_tpu_torch.specgrid.cellspace import CellSpace
from fm_returnprediction_tpu_torch.specgrid.solve import contraction_counts

pytestmark = pytest.mark.torch_port

CPU = "cpu"


def _panel(seed=0, t=30, n=140, p=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, p))
    x[rng.random(x.shape) < 0.06] = np.nan
    beta = rng.standard_normal(p) * 0.1
    y = np.nansum(x * beta, axis=-1) + 0.3 * rng.standard_normal((t, n))
    y[rng.random(y.shape) < 0.1] = np.nan
    masks = {
        "All": np.ones((t, n), bool),
        "Big": (rng.random(n) > 0.35)[None, :] & np.ones((t, n), bool),
    }
    return y, x, masks


def _space_kw(t, p=4):
    names = tuple(f"c{i}" for i in range(p))
    return dict(
        regressor_sets=(("m2", names[:2]), ("mfull", names)),
        universes=("All", "Big"),
        windows=(("full", None), ("half1", (0, t // 2)), ("half2", (t // 2, t))),
        nw_lags=4, min_months=8,
    )


@pytest.fixture(scope="module")
def banks():
    y, x, masks = _panel()
    t = y.shape[0]
    port = grambank.build_bank(y, x, masks, CellSpace(**_space_kw(t)), fingerprint="test-bank",
                               device=CPU)
    ref = jax_grambank.build_bank(y, x, masks, JaxCellSpace(**_space_kw(t)),
                                  fingerprint="test-bank")
    return port, ref, (y, x, masks)


def _assert_leaves_close(got, ref):
    gram, moment = np.asarray(ref.gram), np.asarray(ref.moment)
    scale = np.maximum(np.stack([
        np.abs(gram).max(axis=(-1, -2)), np.abs(moment).max(axis=-1), np.abs(ref.n),
        np.abs(ref.ysum), np.abs(ref.yy)]).max(axis=0), 1.0)
    for name in ("gram", "moment", "ysum", "yy"):
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        s = scale.reshape(scale.shape + (1,) * (a.ndim - 2))
        assert a.shape == b.shape and np.all(np.abs(a - b) <= 1e-12 * s), name
    np.testing.assert_array_equal(got.n, np.asarray(ref.n))
    np.testing.assert_allclose(got.center, np.asarray(ref.center), rtol=1e-13, atol=0)


def test_build_bank_leaves_match(banks):
    port, ref, _ = banks
    _assert_leaves_close(port, ref)
    for field in ("uidx", "col_sel", "months"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))
    assert (port.union, port.universes, port.pair_labels, port.dtype) == \
        (ref.union, ref.universes, ref.pair_labels, ref.dtype)
    assert {k: port.meta[k] for k in ("fingerprint", "precision", "nw_lags", "min_months")} \
        == {k: ref.meta[k] for k in ("fingerprint", "precision", "nw_lags", "min_months")}
    assert "gram_route" not in port.meta
    stats = port.stats(CPU)
    assert stats.gram.dtype == torch.float64 and tuple(stats.gram.shape) == port.gram.shape


@pytest.mark.parametrize("window", [None, (5, 25), "mask"])
def test_window_query_matches_jax(banks, window):
    port, ref, _ = banks
    if window == "mask":
        window = np.zeros(port.n_months, bool)
        window[::2] = True
    got = grambank.window_query(port, window, device=CPU)
    want = jax_grambank.window_query(ref, window)
    np.testing.assert_array_equal(got.n_months, want.n_months)
    np.testing.assert_array_equal(got.month_valid, want.month_valid)
    np.testing.assert_array_equal(got.suspect_months, want.suspect_months)
    for f in ("coef", "nw_se", "mean_r2", "mean_n", "slopes", "r2", "n_obs"):
        a, b = np.asarray(getattr(got, f), float), np.asarray(getattr(want, f), float)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a, b, atol=1e-12, equal_nan=True, err_msg=f)
    np.testing.assert_allclose(got.tstat, want.tstat, atol=1e-10, equal_nan=True)


def test_window_query_rejections(banks):
    port, _, _ = banks
    with pytest.raises(ValueError, match="window mask"):
        grambank.window_query(port, np.ones(port.n_months + 1, bool), device=CPU)
    with pytest.raises(ValueError, match="month LABELS"):
        grambank.window_query(port, (10 * port.n_months, 20 * port.n_months), device=CPU)


def test_bootstrap_query_matches_jax_and_the_host_oracle(banks):
    port, ref, _ = banks
    draws, seed = 8, 3
    point, stacks = grambank.bootstrap_query(port, draws, window=(3, 27), seed=seed,
                                             device=CPU)
    want_point, want_stacks = jax_grambank.bootstrap_query(ref, draws, window=(3, 27),
                                                           seed=seed)
    np.testing.assert_allclose(point.coef, want_point.coef, atol=1e-12, equal_nan=True)
    idx = boot.resample_matrix(port.n_months, draws, seed=seed)
    mask = np.zeros(port.n_months, bool)
    mask[3:27] = True
    assert len(stacks) == port.n_pairs
    for k in range(port.n_pairs):
        for got, want in zip(stacks[k], want_stacks[k]):
            assert got.shape == np.asarray(want).shape
            np.testing.assert_allclose(got, want, atol=1e-12, equal_nan=True)
        for d in range(draws - 1):
            rows = idx[d]
            oracle = fm_aggregate_np(point.slopes[k][rows], point.r2[k][rows],
                                     point.n_obs[k][rows], (point.month_valid[k] & mask)[rows],
                                     4, 8, "reference")
            np.testing.assert_allclose(stacks[k][0][d], oracle[0], atol=1e-12, equal_nan=True)
            assert int(stacks[k][5][d]) == oracle[5]
    with pytest.raises(ValueError, match="draws"):
        grambank.bootstrap_query(port, 0, device=CPU)


def test_ingest_month_additivity(banks):
    full, ref_full, (y, x, masks) = banks
    t = y.shape[0]
    head_masks = {k: v[: t - 1] for k, v in masks.items()}
    last = {k: v[t - 1] for k, v in masks.items()}
    head = grambank.build_bank(y[: t - 1], x[: t - 1], head_masks, CellSpace(**_space_kw(t)),
                               fingerprint="test-bank", device=CPU)
    grown = grambank.ingest_month(head, y[t - 1], x[t - 1], last, month=t - 1, device=CPU)
    assert grown.n_months == t
    for f in ("gram", "moment", "n", "ysum", "yy", "center"):
        a = getattr(full, f)
        np.testing.assert_allclose(getattr(grown, f), a,
                                   atol=1e-13 * max(np.nanmax(np.abs(a)), 1), err_msg=f)
    np.testing.assert_array_equal(grown.months, full.months)
    np.testing.assert_allclose(grambank.window_query(grown, device=CPU).coef,
                               grambank.window_query(full, device=CPU).coef,
                               atol=1e-11, equal_nan=True)
    ref_head = jax_grambank.build_bank(y[: t - 1], x[: t - 1], head_masks,
                                       JaxCellSpace(**_space_kw(t)), fingerprint="test-bank")
    _assert_leaves_close(grown, jax_grambank.ingest_month(ref_head, y[t - 1], x[t - 1], last,
                                                          month=t - 1))
    with pytest.raises(ValueError, match="already banked"):
        grambank.ingest_month(grown, y[t - 1], x[t - 1], last, month=t - 1, device=CPU)
    with pytest.raises(ValueError, match="union"):
        grambank.ingest_month(grown, y[t - 1], x[t - 1][:, :2], last, month=t, device=CPU)


def test_scenario_query_schema_and_zero_panel_reads(banks):
    port, ref, _ = banks
    before = contraction_counts()
    kw = dict(windows={"full": None, "late": (20, 30)}, bootstrap=3, label_of={"c0": "Beta"})
    frame = grambank.scenario_query(port, device=CPU, **kw)
    assert contraction_counts() == before
    want = jax_grambank.scenario_query(ref, **kw)
    assert list(frame.columns) == list(want.columns)
    assert len(frame) == len(want) == 2 * 3 * int(port.col_sel.sum())
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(frame[c], want[c], atol=1e-10, rtol=1e-10,
                                       equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(frame[c].to_numpy(), want[c].to_numpy(), err_msg=c)


def test_scenario_query_with_an_estimator_raises(banks):
    """``scenario_query(estimator="fwl:c0")`` and ``run_scenarios_banked``
    (once refused here) against the reference's frames, with no panel
    contraction; the bank-unservable absorb kind still raises."""
    port, ref, _ = banks
    kw = dict(windows={"full": None, "late": (20, 30)}, estimator="fwl:c0")
    before = contraction_counts()
    frame = grambank.scenario_query(port, device=CPU, **kw)
    banked = scenarios.run_scenarios_banked(port, device=CPU, **kw)
    assert contraction_counts() == before
    for got, want in ((frame, jax_grambank.scenario_query(ref, **kw)),
                      (banked, jax_scenarios.run_scenarios_banked(ref, **kw))):
        assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
        for c in want.columns:
            if want[c].dtype.kind == "f":
                np.testing.assert_allclose(got[c], want[c], atol=1e-10, rtol=1e-10,
                                           equal_nan=True, err_msg=c)
            else:
                np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(),
                                              err_msg=c)
    assert set(frame["estimator"]) == {"fwl[c0]"} and "c0" not in set(frame["predictor"])
    with pytest.raises(ValueError, match="absorb"):
        grambank.scenario_query(port, estimator="absorb:ind", device=CPU)


class _MiniPanel:
    def __init__(self, y, x, mask, names):
        self.y, self.x, self.mask, self.names = y, x, mask, names
        self.months = np.arange(y.shape[0])

    def var(self, name):
        assert name == "retx"
        return self.y

    def select(self, cols):
        return self.x[:, :, [self.names.index(c) for c in cols]]


def test_run_scenarios_banked_matches_run_scenarios():
    y, x, masks = _panel(seed=21, t=36, n=80, p=3)
    names = ["c0", "c1", "c2"]
    panel = _MiniPanel(y, x, masks["All"], names)
    variables = {"V0": "c0", "V1": "c1", "V2": "c2"}
    models = [ModelSpec("Model A", ["V0", "V1"]), ModelSpec("Model B", ["V0", "V1", "V2"])]
    ref = scenarios.run_scenarios(panel, masks, variables, models=models, subperiods=2,
                                  min_months=8)
    bk = scenarios.bank_for_scenarios(panel, masks, variables, models=models, min_months=8,
                                      device=CPU)
    got = scenarios.run_scenarios_banked(bk, windows=scenarios.subperiod_windows(bk.n_months, 2),
                                         variables_dict=variables, device=CPU)
    keys = ["model", "universe", "window", "predictor"]
    merged = ref.merge(got, on=keys, suffixes=("_ref", "_bank"))
    assert len(merged) == len(ref) == len(got)
    for f in ("coef", "tstat", "nw_se", "mean_r2", "mean_n"):
        np.testing.assert_allclose(merged[f"{f}_bank"], merged[f"{f}_ref"], atol=1e-9,
                                   equal_nan=True, err_msg=f)
    assert (merged["n_months_bank"] == merged["n_months_ref"]).all()

    jax_models = [JaxModelSpec(m.name, m.predictors) for m in models]
    jax_bank = jax_scenarios.bank_for_scenarios(panel, masks, variables, models=jax_models,
                                                min_months=8)
    want = jax_scenarios.run_scenarios_banked(
        jax_bank, windows=jax_scenarios.subperiod_windows(jax_bank.n_months, 2),
        variables_dict=variables, bootstrap=4)
    got = scenarios.run_scenarios_banked(bk, windows=scenarios.subperiod_windows(bk.n_months, 2),
                                         variables_dict=variables, bootstrap=4, device=CPU)
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c], atol=1e-10, rtol=1e-10,
                                       equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=c)


def test_bootstrap_aggregate_pairs_rows_are_the_single_series_rows(banks):
    port, _, _ = banks
    point = grambank.window_query(port, device=CPU)
    idx = boot.resample_matrix(port.n_months, 9, seed=5)
    stacked = boot.bootstrap_aggregate_pairs(point.slopes, point.r2, point.n_obs,
                                             point.month_valid, idx, 4, 8, "reference",
                                             device=CPU)
    assert stacked[0].shape == (port.n_pairs, 8, len(port.union))
    for k in range(port.n_pairs):
        single = boot.bootstrap_aggregate_device(point.slopes[k], point.r2[k], point.n_obs[k],
                                                 point.month_valid[k], idx, 4, 8, "reference",
                                                 device=CPU)
        for got, want in zip(stacked, single):
            np.testing.assert_array_equal(got[k], want)


@pytest.mark.parametrize("fn", ["bootstrap_aggregate_device", "bootstrap_aggregate_pairs"])
def test_bootstrap_aggregation_defaults_to_the_gpu(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = 12
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(boot, fn)(np.zeros((t, 2)), np.zeros(t), np.zeros(t), np.ones(t, bool),
                          boot.resample_matrix(t, 3), 4, 2, "reference")


def test_bank_entry_points_default_to_the_gpu(banks, monkeypatch):
    port, _, (y, x, masks) = banks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grambank.window_query(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grambank.build_bank(y, x, masks, CellSpace(**_space_kw(y.shape[0])))
