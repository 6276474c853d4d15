"""The warm Lewellen main path, back to back: one client, closed loop.

Each call is ``pipeline.run_pipeline`` from the prepared inputs, in float32
with the guard on, as the command line runs it: characteristics (the daily
strips and the monthly columns), universes, Tables 1 and 2, Figure 1's
slopes, the decile sorts and the serving state. It writes no artifact: the
artifact writer draws Figure 1 with matplotlib, which the card's machine
lacks, so ``output_dir`` stays unset.
"""

from __future__ import annotations

import time
import numpy as np
import torch

from portbench.compare import column_scale, fm_gaps, nan_mismatch, rel_gap, scaled_gap
from portbench.inputs.lewellen import make_lewellen_inputs
from portbench.reference import lewellen as ref_lewellen
from portbench.reference.fm import tf32_products


def program_inputs(inp):
    """The generated arrays as the program's prepared inputs."""
    from fm_returnprediction_tpu_torch.panel.daily import CompactDaily
    from fm_returnprediction_tpu_torch.panel.dense import DensePanel

    base = DensePanel(values=inp["values"], mask=inp["mask"], months=inp["months"],
                      ids=inp["ids"], var_names=list(inp["var_names"]))
    daily = CompactDaily(
        row_values=inp["row_values"], row_pos=inp["row_pos"], offsets=inp["offsets"],
        ids=inp["ids"], mkt=inp["mkt"], mkt_present=inp["mkt_present"], days=inp["days"],
        day_month_id=inp["day_month_id"], week_id=inp["week_id"], n_weeks=inp["n_weeks"],
        week_month_id=inp["week_month_id"], n_months=inp["n_months"])
    return base, daily


def run_main_path(base, daily, device):
    from fm_returnprediction_tpu_torch.pipeline import run_pipeline

    return run_pipeline(dense_base=base, compact_daily=daily, device=device,
                        dtype=torch.float32, guard=True, compile_pdf=False)


class Traffic:
    def __init__(self, cell, config, seed, device, sizes=None):
        self.params = cell["params"]
        self.dtype = config["dtype"]
        self.sizes = {**config["sizes"], **(sizes or {})}
        self.seed = int(seed)
        self.device = device
        self.phases = {}

    def setup(self):
        t0 = time.perf_counter()
        self.inp = make_lewellen_inputs(self.seed, n_firms=self.sizes["n_firms"],
                                        n_months=self.sizes["n_months"], device=self.device)
        self.base, self.daily = program_inputs(self.inp)
        self.phases["inputs_s"] = time.perf_counter() - t0
        self.phases["warm_s"] = []
        for _ in range(int(self.params["warm_calls"])):
            t0 = time.perf_counter()
            self.call()
            self.phases["warm_s"].append(time.perf_counter() - t0)

    def call(self):
        return run_main_path(self.base, self.daily, self.device)

    def stage_seconds(self, res):
        return dict(res.stage_seconds)

    def work(self):
        t = int(self.inp["n_months"])
        alive = int(np.asarray(self.inp["mask"]).sum())
        # the daily standard deviation over every daily row; the two monthly
        # rolling sums (dividends, log returns); Figure 1's 120-month means
        # of 5 slopes in 3 universes; the forecasts' of 6 coefficients in 3
        # universes and the serving state
        return {"k1_elements": [len(self.inp["row_values"]), alive, alive,
                                t * 5 * 3, t * 6 * 4]}

    def outputs(self, res):
        panel = res.panel
        cols = {c: panel.var(c).detach().cpu().numpy()
                for c in ref_lewellen.FACTORS.values()}
        t1 = res.table_1
        table_1 = {u: (t1[(u, "Avg")].to_numpy(float), t1[(u, "Std")].to_numpy(float),
                       t1[(u, "N")].to_numpy(float)) for u in ref_lewellen.UNIVERSES}
        dec = res.decile_table
        deciles = {u: {"mean_returns": dec[u].to_numpy(float)[:10],
                       "spread": float(dec.loc["10-1 spread", u]),
                       "spread_tstat": float(dec.loc["t(spread)", u]),
                       "n_months": int(dec.loc["Months", u])} for u in ref_lewellen.UNIVERSES}
        st = res.serving_state
        return {
            "columns": cols,
            "universes": {k: np.asarray(torch.as_tensor(v).cpu()) for k, v in
                          res.subset_masks.items()},
            "table_1": table_1,
            "table_2": {k: dict(v) for k, v in res.table_2_cells.items()},
            "figure_1": {u: f.to_numpy(float) for u, f in res.figure_1.items()},
            "deciles": deciles,
            "serving": np.concatenate([np.asarray(st.intercept_bar)[:, None],
                                       np.asarray(st.slopes_bar)], axis=1),
        }

    def release(self):
        pass

    def reference(self, dtype, tf32):
        with tf32_products(tf32):
            return ref_lewellen.replicate(self.inp, dtype=dtype, device=self.device,
                                          breakpoint_dtype=getattr(torch, self.dtype))

    def compare(self, got, ref):
        return compare_main(got, ref)

    def as_answer(self, ref):
        """A reference's output in the form of ``outputs``: the control's
        answers, put in the program's place."""
        out = dict(ref)
        out["table_2"] = {k: {"coef": fr.coef.cpu().numpy(), "tstat": fr.tstat.cpu().numpy(),
                              "nw_se": fr.nw_se.cpu().numpy(), "mean_r2": fr.mean_r2,
                              "mean_n": fr.mean_n} for k, fr in ref["table_2"].items()}
        return out


def compare_main(got, ref) -> dict:
    """The numbers of the main path against the reference's."""
    out = {}
    char_gap, char_nan = 0.0, 0
    for c, r in ref["columns"].items():
        g = got["columns"][c]
        char_nan += nan_mismatch(g, r)
        both = np.isfinite(g) & np.isfinite(r)
        if both.any():
            char_gap = max(char_gap, float(np.max(np.abs(g[both] - r[both])))
                           / column_scale(r))
    out["char_gap"] = char_gap
    out["char_nan"] = char_nan
    out["universe_diff"] = int(sum((got["universes"][u] != r).sum()
                                   for u, r in ref["universes"].items()))
    t1_gap, t1_n = 0.0, 0
    for u, (avg_r, std_r, n_r) in ref["table_1"].items():
        avg_g, std_g, n_g = got["table_1"][u]
        t1_gap = max(t1_gap, scaled_gap(avg_g, avg_r, std_r), scaled_gap(std_g, std_r, std_r))
        t1_n += int(np.abs(np.asarray(n_g) - np.asarray(n_r)).sum())
    out["t1_gap"] = t1_gap
    out["t1_n"] = t1_n
    coef = tstat = se = r2 = nn = 0.0
    for key, fr in ref["table_2"].items():
        cell = got["table_2"][key]
        c, t, e = fm_gaps(cell["coef"], cell["tstat"], cell["nw_se"], fr)
        coef, tstat, se = max(coef, c), max(tstat, t), max(se, e)
        r2 = max(r2, rel_gap([cell["mean_r2"]], [fr.mean_r2]))
        nn = max(nn, rel_gap([cell["mean_n"]], [fr.mean_n]))
    out.update(t2_coef=coef, t2_tstat=tstat, t2_se=se, t2_r2=r2, t2_n=nn)
    fig = 0.0
    for u, r in ref["figure_1"].items():
        g = got["figure_1"][u]
        fig = max(fig, scaled_gap(g, r, np.nanmax(np.abs(r), axis=0)) if g.shape == r.shape
                  else float("inf"))
    out["fig_gap"] = fig
    dec_ret = dec_t = 0.0
    dec_months = 0
    for u, r in ref["deciles"].items():
        g = got["deciles"][u]
        se_spread = abs(r["spread"] / r["spread_tstat"])
        dec_ret = max(dec_ret, scaled_gap(g["mean_returns"], r["mean_returns"], se_spread))
        dec_t = max(dec_t, abs(g["spread_tstat"] - r["spread_tstat"]))
        dec_months += abs(g["n_months"] - r["n_months"])
    out.update(dec_ret=dec_ret, dec_t=dec_t, dec_months=dec_months)
    out["serving_gap"] = scaled_gap(got["serving"], ref["serving"],
                                    np.nanmax(np.abs(ref["serving"]), axis=0))
    return out
