"""A spec grid solved back to back: one client, closed loop.

Each call is ``specgrid.solve.run_spec_grid(y, x, masks, grid)`` with the
referee on and the factorization at its default: the cell's column set ×
universes × windows (``product_grid``), over inputs made once from the seed.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.compare import fm_gaps, rel_gap
from portbench.inputs.ghz import UNIVERSES, make_ghz_inputs
from portbench.reference.fm import spec_table, tf32_products


class Traffic:
    def __init__(self, cell, config, seed, device, sizes=None):
        self.params = cell["params"]
        self.config = config
        self.sizes = {**config["sizes"], **(sizes or {})}
        self.seed = int(seed)
        self.device = device
        self.phases = {}

    def setup(self):
        from fm_returnprediction_tpu_torch.specgrid.specs import product_grid

        t0 = time.perf_counter()
        inp = make_ghz_inputs(self.seed, self.device, n_firms=self.sizes["n_firms"],
                              n_months=self.sizes["n_months"], n_chars=self.sizes["n_chars"])
        self.y, self.x, self.masks = inp["y"], inp["x"], inp["masks"]
        t = int(inp["n_months"])
        self.cols = [f"c{k + 1:02d}" for k in range(self.x.shape[-1])]
        self.windows = {name: (int(lo * t / 420), int(hi * t / 420))
                        for name, (lo, hi) in self.config["windows"].items()}
        self.grid = product_grid({"all": tuple(self.cols)}, list(UNIVERSES), self.windows,
                                 nw_lags=self.config["nw_lags"],
                                 min_months=self.config["min_months"])
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        self.phases["inputs_s"] = time.perf_counter() - t0
        self.phases["warm_s"] = []
        for _ in range(int(self.params["warm_calls"])):
            t0 = time.perf_counter()
            self.call()
            self.phases["warm_s"].append(time.perf_counter() - t0)

    def call(self):
        from fm_returnprediction_tpu_torch.specgrid.solve import run_spec_grid

        return run_spec_grid(self.y, self.x, self.masks, self.grid)

    def stage_seconds(self, res):
        return {}

    def work(self):
        """One contraction a (universe, column set) pair over the months of
        its windows' union; its rows of nonzero weight are the universe's
        firm-months whose return and every column are finite."""
        t, n, p = self.x.shape
        finite = torch.isfinite(self.y) & torch.isfinite(self.x).all(dim=-1)
        span = torch.zeros(t, dtype=torch.bool, device=self.y.device)
        for lo, hi in self.windows.values():
            span[lo:hi] = True
        pairs = [(int((self.masks[u] & finite & span[:, None]).sum()), p) for u in UNIVERSES]
        inputs = [self.x.numel() * self.x.element_size(), self.y.numel() * self.y.element_size()]
        inputs += [m.numel() for m in self.masks.values()]
        return {"k2": {"pairs": pairs, "inputs": inputs, "months": t}}

    def outputs(self, res):
        return res

    def release(self):
        pass

    def specs(self):
        t = self.y.shape[0]
        out = []
        for spec in self.grid.specs:
            win = torch.zeros(t, dtype=torch.bool, device=self.y.device)
            lo, hi = spec.window
            win[lo:hi] = True
            out.append((list(range(len(self.cols))), spec.universe, win))
        return out

    def reference(self, dtype, tf32):
        with tf32_products(tf32):
            return spec_table(self.y, self.x, self.masks, self.specs(), dtype=dtype,
                              nw_lags=self.config["nw_lags"],
                              min_months=self.config["min_months"])

    def compare(self, res, ref):
        return compare_grid(res, ref)

    def as_answer(self, ref):
        """A reference's output in the form of ``outputs``: the control's
        answers, put in the program's place."""
        def stack(key):
            return np.stack([getattr(fr, key).cpu().numpy() for fr in ref])

        return SimpleNamespace(
            coef=stack("coef"), tstat=stack("tstat"), nw_se=stack("nw_se"),
            mean_r2=np.array([fr.mean_r2 for fr in ref]),
            mean_n=np.array([fr.mean_n for fr in ref]),
            n_months=np.array([fr.n_months for fr in ref]),
            suspect_months=np.array([fr.suspect_months for fr in ref]))


def compare_grid(res, ref) -> dict:
    coef = tstat = se = r2 = 0.0
    n_diff = months_diff = suspect_diff = 0
    for s, fr in enumerate(ref):
        c, t, e = fm_gaps(res.coef[s], res.tstat[s], res.nw_se[s], fr)
        coef, tstat, se = max(coef, c), max(tstat, t), max(se, e)
        r2 = max(r2, rel_gap([res.mean_r2[s]], [fr.mean_r2]))
        n_diff += abs(int(round(float(res.mean_n[s]) * int(res.n_months[s]))) - fr.n_obs)
        months_diff += abs(int(res.n_months[s]) - fr.n_months)
        suspect_diff += abs(int(res.suspect_months[s]) - fr.suspect_months)
    return {"coef_gap": coef, "tstat_gap": tstat, "se_gap": se, "r2_gap": r2,
            "n_obs_diff": n_diff, "n_months_diff": months_diff,
            "suspect_diff": suspect_diff}
