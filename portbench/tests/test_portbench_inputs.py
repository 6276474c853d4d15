"""The frozen input generators: one seed gives the same inputs, another seed
others, and the GHZ panel is the Lewellen monthly panel's last months built
without a single daily row."""

import numpy as np
import pytest
import torch

from portbench.inputs.ghz import UNIVERSES, make_ghz_inputs
from portbench.inputs.lewellen import make_lewellen_inputs

BIG_SEED = 2**31 + 977


def _same(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True)
               for k in a if not isinstance(a[k], (int, list)))


def test_lewellen_inputs_repeat_from_the_seed():
    a = make_lewellen_inputs(BIG_SEED, n_firms=300, n_months=80)
    b = make_lewellen_inputs(BIG_SEED, n_firms=300, n_months=80)
    c = make_lewellen_inputs(BIG_SEED + 1, n_firms=300, n_months=80)
    assert _same(a, b)
    assert not np.array_equal(a["row_values"][:1000], c["row_values"][:1000], equal_nan=True)
    assert a["values"].dtype == np.float32 and a["row_values"].dtype == np.float32
    # the same layout in another order: as many firm-months and daily rows
    assert a["mask"].sum() == c["mask"].sum() and len(a["row_values"]) == len(c["row_values"])
    assert not np.array_equal(a["mask"], c["mask"])
    # every firm has rows, firm-major and chronological within a firm
    counts = np.diff(a["offsets"])
    assert (counts > 0).all() and counts.sum() == len(a["row_values"])
    assert (np.diff(a["row_pos"].astype(np.int64))[np.diff(
        np.repeat(np.arange(300), counts)) == 0] == 1).all()


def test_monthly_panel_does_not_depend_on_the_daily_rows():
    full = make_lewellen_inputs(17, n_firms=250, n_months=90)
    monthly = make_lewellen_inputs(17, n_firms=250, n_months=90, daily=False)
    assert "row_values" not in monthly
    assert np.array_equal(full["values"], monthly["values"], equal_nan=True)
    assert np.array_equal(full["mask"], monthly["mask"])


def test_early_cross_sections_are_not_thin():
    inp = make_lewellen_inputs(5, n_firms=2000, n_months=120, daily=False)
    alive = inp["mask"].sum(axis=1)
    assert alive[0] > 0.15 * 2000 and alive.min() > 0.15 * 2000


def test_ghz_inputs_repeat_and_cut_the_lewellen_months():
    a = make_ghz_inputs(BIG_SEED, "cpu", n_firms=300, n_months=420, n_chars=12)
    b = make_ghz_inputs(BIG_SEED, "cpu", n_firms=300, n_months=420, n_chars=12)
    assert torch.equal(torch.nan_to_num(a["x"], 9.0), torch.nan_to_num(b["x"], 9.0))
    assert torch.equal(torch.nan_to_num(a["y"], 9.0), torch.nan_to_num(b["y"], 9.0))
    assert a["x"].shape == (420, 300, 12) and a["x"].dtype == torch.float32
    base = make_lewellen_inputs(BIG_SEED, n_firms=300, n_months=600, start="1965-01-31",
                                daily=False)
    alive = torch.as_tensor(base["mask"][180:])
    assert torch.equal(a["masks"][UNIVERSES[0]], alive)
    assert str(base["months"][180])[:7] == "1980-01" and str(base["months"][-1])[:7] == "2014-12"
    # alive rows are finite and standardized each month; the rest are NaN
    x = a["x"]
    assert bool(torch.isfinite(x[alive]).all()) and bool(torch.isnan(x[~alive]).all())
    mean = torch.nanmean(x, dim=1)
    assert float(mean.abs().max()) < 1e-4
    for big, small in ((UNIVERSES[0], UNIVERSES[1]), (UNIVERSES[1], UNIVERSES[2])):
        assert bool((a["masks"][small] <= a["masks"][big]).all())


@pytest.mark.parametrize("q", [0.2, 0.5])
def test_ghz_breakpoints_are_linear_quantiles_of_nyse_me(q):
    from portbench.inputs.ghz import nyse_universes

    g = torch.Generator().manual_seed(3)
    me = torch.rand((4, 50), generator=g, dtype=torch.float64) * 100
    alive = torch.rand((4, 50), generator=g) < 0.9
    nyse = torch.rand((4, 50), generator=g) < 0.4
    masks = nyse_universes(me, alive, nyse)
    name = UNIVERSES[1] if q == 0.2 else UNIVERSES[2]
    for t in range(4):
        bp = np.quantile(me[t][alive[t] & nyse[t]].numpy(), q)
        assert torch.equal(masks[name][t], alive[t] & (me[t] >= bp))
