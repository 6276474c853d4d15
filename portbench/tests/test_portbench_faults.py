"""Each cell's comparison catches a broken timed path.

The test skips the harness's look for a card and drives the rest of a run on
the CPU at a small size, with the program broken underneath: half of the
firms left out of the work (the means then taken over the rest), or one
answer altered where it is produced. ``correct`` must come out false; the
unbroken run must come out true. The cells hold no state between calls and
run on one card, so a step that returns its state unchanged and the
exchange between cards are not faults they can have.
"""

import pytest
import torch

from portbench.harness import run_cell

SIZES = {
    "lewellen.main": {"n_firms": 1500, "n_months": 160},
    "lewellen.sweep": {"n_firms": 1500, "n_months": 160},
    "ghz.grid": {"n_firms": 1500, "n_months": 120, "n_chars": 20},
}
SEED = 2**31 + 4242


def _half(mask):
    m = torch.as_tensor(mask).clone()
    m[:, m.shape[1] // 2:] = False
    return m


def _break(monkeypatch, name, fault):
    if name == "ghz.grid":
        import fm_returnprediction_tpu_torch.specgrid.solve as mod

        real = mod.run_spec_grid

        def broken(y, x, masks, grid, **kw):
            if fault == "half":
                return real(y, x, {k: _half(v) for k, v in masks.items()}, grid, **kw)
            res = real(y, x, masks, grid, **kw)
            res.coef[0, 0] += 0.01 * res.nw_se[0, 0]
            return res

        monkeypatch.setattr(mod, "run_spec_grid", broken)
    elif name == "lewellen.sweep":
        import fm_returnprediction_tpu_torch.specgrid.scenarios as mod

        real = mod.run_scenarios

        def broken(panel, masks, factors, **kw):
            if fault == "half":
                return real(panel, {k: _half(v) for k, v in masks.items()}, factors, **kw)
            frame = real(panel, masks, factors, **kw)
            frame.loc[0, "coef"] += 0.01 * frame.loc[0, "nw_se"]
            return frame

        monkeypatch.setattr(mod, "run_scenarios", broken)
    else:
        import fm_returnprediction_tpu_torch.pipeline as mod

        real = mod.run_pipeline

        def broken(**kw):
            if fault == "half":
                base = kw["dense_base"]
                kw["dense_base"] = type(base)(values=base.values, mask=_half(base.mask).numpy(),
                                              months=base.months, ids=base.ids,
                                              var_names=base.var_names)
                return real(**kw)
            res = real(**kw)
            cell = next(iter(res.table_2_cells.values()))
            cell["coef"][0] += 0.01 * cell["nw_se"][0]
            return res

        monkeypatch.setattr(mod, "run_pipeline", broken)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_unbroken_run_is_correct(name):
    res, compared = run_cell(name, SEED, 0.5, False, device="cpu", sizes=SIZES[name])
    assert compared, "the cell compares nothing"
    assert res["correct"], compared


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_broken_run_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, name, fault)
    res, compared = run_cell(name, SEED, 0.5, False, device="cpu", sizes=SIZES[name])
    assert not res["correct"], compared
