"""The robustness sweep around Table 2, back to back: one client, closed loop.

Set-up builds the enriched panel with one main-path call, as ``--specgrid``
does before its sweep; each timed call is ``specgrid.scenarios.run_scenarios
(panel, masks, factors)`` at its defaults: 3 models × 3 universes × the whole
sample and its two halves, 27 cells on the Gram route with the QR referee.
"""

from __future__ import annotations

import time
import numpy as np
import pandas as pd
import torch

from portbench.compare import fm_gaps, rel_gap
from portbench.inputs.lewellen import make_lewellen_inputs
from portbench.reference import lewellen as ref_lewellen
from portbench.reference.fm import fm_summary, monthly_cs, tf32_products
from portbench.traffic.main_path import program_inputs, run_main_path


def halves(t: int):
    """The sweep's windows: the whole sample and two equal halves."""
    mid = int(np.linspace(0, t, 3).astype(int)[1])
    return {"full": (0, t), "sub1of2": (0, mid), "sub2of2": (mid, t)}


class Traffic:
    def __init__(self, cell, config, seed, device, sizes=None):
        self.params = cell["params"]
        self.config = config
        self.sizes = {**config["sizes"], **(sizes or {})}
        self.seed = int(seed)
        self.device = device
        self.phases = {}

    def setup(self):
        t0 = time.perf_counter()
        self.inp = make_lewellen_inputs(self.seed, n_firms=self.sizes["n_firms"],
                                        n_months=self.sizes["n_months"], device=self.device)
        base, daily = program_inputs(self.inp)
        self.phases["inputs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run_main_path(base, daily, self.device)
        self.panel, self.masks, self.factors = res.panel, res.subset_masks, res.factors_dict
        del res, base, daily
        self.phases["panel_s"] = time.perf_counter() - t0
        self.phases["warm_s"] = []
        for _ in range(int(self.params["warm_calls"])):
            t0 = time.perf_counter()
            self.call()
            self.phases["warm_s"].append(time.perf_counter() - t0)

    def call(self):
        from fm_returnprediction_tpu_torch.specgrid.scenarios import run_scenarios

        return run_scenarios(self.panel, self.masks, self.factors)

    def stage_seconds(self, frame):
        return {}

    def work(self):
        """One contraction a (model, universe) pair over every month (the
        halves split the whole sample); its rows of nonzero weight are the
        universe's firm-months whose return and the model's columns are
        finite in the panel the sweep reads."""
        y = self.panel.var("retx")
        t = y.shape[0]
        pairs = []
        for cols in ref_lewellen.MODELS.values():
            x = self.panel.select(cols)
            fin = torch.isfinite(y) & torch.isfinite(x).all(dim=-1)
            pairs += [(int((torch.as_tensor(self.masks[u], device=y.device) & fin).sum()),
                       len(cols)) for u in ref_lewellen.UNIVERSES]
        union = ref_lewellen.MODELS["Model 3: Fourteen Predictors"]
        inputs = [t * y.shape[1] * len(union) * y.element_size(), y.numel() * y.element_size()]
        inputs += [y.numel()] * len(ref_lewellen.UNIVERSES)
        return {"k2": {"pairs": pairs, "inputs": inputs, "months": t}}

    def outputs(self, frame):
        return frame

    def release(self):
        self.panel = self.masks = None

    def reference(self, dtype, tf32):
        with tf32_products(tf32):
            panel = ref_lewellen.build_panel(self.inp, dtype, self.device)
            unis = ref_lewellen.universes(panel, getattr(torch, self.config["dtype"]))
            t = panel["retx"].shape[0]
            out = {}
            for model, cols in ref_lewellen.MODELS.items():
                x = torch.stack([panel[c] for c in cols], dim=-1)
                for uni in ref_lewellen.UNIVERSES:
                    cs = monthly_cs(panel["retx"], x, unis[uni], dtype=dtype)
                    for win, (lo, hi) in halves(t).items():
                        w = torch.zeros(t, dtype=torch.bool, device=x.device)
                        w[lo:hi] = True
                        out[(model, uni, win)] = fm_summary(cs, w)
                del x
            return out

    def compare(self, frame, ref):
        return compare_sweep(frame, ref)

    def as_answer(self, ref):
        """A reference's output in the form of ``outputs`` (the sweep's
        frame): the control's answers, put in the program's place."""
        label = {c: lab for lab, c in ref_lewellen.FACTORS.items()}
        rows = []
        for (model, uni, win), fr in ref.items():
            for j, col in enumerate(ref_lewellen.MODELS[model]):
                rows.append({"model": model, "universe": uni, "window": win,
                             "predictor": label[col], "coef": float(fr.coef[j]),
                             "tstat": float(fr.tstat[j]), "nw_se": float(fr.nw_se[j]),
                             "mean_r2": fr.mean_r2, "mean_n": fr.mean_n,
                             "n_months": fr.n_months})
        return pd.DataFrame(rows)


def compare_sweep(frame, ref) -> dict:
    label = {c: lab for lab, c in ref_lewellen.FACTORS.items()}
    coef = tstat = se = r2 = nn = 0.0
    months_diff = missing = 0
    for (model, uni, win), fr in ref.items():
        rows = frame[(frame["model"] == model) & (frame["universe"] == uni)
                     & (frame["window"] == win)]
        want = [label[c] for c in ref_lewellen.MODELS[model]]
        if list(rows["predictor"]) != want:
            missing += 1
            continue
        c, t, e = fm_gaps(rows["coef"].to_numpy(float), rows["tstat"].to_numpy(float),
                          rows["nw_se"].to_numpy(float), fr)
        coef, tstat, se = max(coef, c), max(tstat, t), max(se, e)
        r2 = max(r2, rel_gap([rows["mean_r2"].iloc[0]], [fr.mean_r2]))
        nn = max(nn, rel_gap([rows["mean_n"].iloc[0]], [fr.mean_n]))
        months_diff += abs(int(rows["n_months"].iloc[0]) - fr.n_months)
    return {"coef_gap": coef, "tstat_gap": tstat, "se_gap": se, "r2_gap": r2, "n_gap": nn,
            "n_months_diff": months_diff, "cells_missing": missing}
