"""The estimator grid runner: a whole spec grid under one estimator kind.

``run_estimator_grid_weights`` is the estimator-family twin of
``solve.run_spec_grid_weights`` — the same panel inputs, the same
``Dict[weight -> SpecGridResult]`` out — with the estimator's Gram-stat
transform between the contraction and the padded solve:

    contract (per spec, or per unique pair) → estimator transform
    (fwl / iv / absorb) → padded eigh solve → FM aggregation per weight and
    SE family

and the pooled kind's month-summed sandwich (``estimators.cluster``) in
place of the last two steps.

What runs on the card: the contraction is ``grams.contract_spec_grams``,
the Gram kernel K2 (``csrc/gram.cu``) on CUDA tensors with its float32,
float64, bfloat16 and row-weight branches; everything after it is plain
torch, as in the reference, where the transforms, the FE cell sums and the
pooled meats are einsums and ``segment_sum`` outside any Pallas kernel.
K2 takes a union of any width (estimator columns ride the union: FWL
controls and IV instruments must be union columns).

Route discipline, as in the reference:

- the month-axis FACTORIZATION composes: fwl/iv/pooled contract per unique
  (universe, effective col_sel) pair and expand window masks at the stats
  level (``solve.expand_window_stats``, exact); absorb's cell contraction
  is per spec and stays per spec;
- the CORESET route composes: ``row_weights`` flows into every
  contraction (Gram, FE cells, pooled meats);
- precision: every pinv/rank cutoff uses the eps of the dtype the stats
  were CONTRACTED in (bfloat16's under ``precision="bf16"``). The
  reference raises float32 stats to float64 before the transform under its
  x64 flag; the port transforms and solves at the stats' dtype (float32
  stats in float32), as ``specgrid.solve`` and ``backtest.paths`` do, so
  parity with the reference is held at float64;
- NO QR referee: a partialled/absorbed/instrumented cell is a different
  estimand than plain OLS, so the referee is off and every conditioning
  event is DISCLOSED (``suspect_months``, and the per-kind disclosures:
  transform rank loss, absorb iteration and convergence counts);
- one device in one process: the engine refuses a mesh or several
  processes before any estimator runs, as the reference does.

The ``solve.CONTRACTIONS`` ledger keys (``specs_solved``,
``specs_contracted``, ``pairs_unique``, ``pairs_contracted``) count this
route's work like the OLS grid's. The reference's program-trace counter
(``record_trace``) has no counterpart in eager torch (``telemetry.metrics``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.guard import checks as _guard
from fm_returnprediction_tpu_torch.ops.fama_macbeth import fama_macbeth_summary
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult
from fm_returnprediction_tpu_torch.specgrid.estimators.absorb import (
    absorb_transform,
    contract_absorb_cells,
)
from fm_returnprediction_tpu_torch.specgrid.estimators.cluster import (
    fm_cluster_summary,
    pooled_fit,
)
from fm_returnprediction_tpu_torch.specgrid.estimators.core import Estimator
from fm_returnprediction_tpu_torch.specgrid.estimators.fwl import fwl_transform
from fm_returnprediction_tpu_torch.specgrid.estimators.iv import iv_r2, iv_transform
from fm_returnprediction_tpu_torch.specgrid.grams import (
    contract_spec_grams,
    resolve_gram_factorize,
    resolve_gram_precision,
    unique_pairs,
)
from fm_returnprediction_tpu_torch.specgrid.solve import (
    BF16_EPS,
    CONTRACTIONS,
    SpecGridResult,
    expand_window_stats,
    solve_spec_stats,
)

__all__ = ["run_estimator_grid_weights"]


def _positions(union: Tuple[str, ...], names: Tuple[str, ...], what: str) -> np.ndarray:
    """(P,) bool mask of ``names`` inside the union predictor order — loud
    on a name the union does not carry."""
    mask = np.zeros(len(union), bool)
    for nm in names:
        if nm not in union:
            raise KeyError(
                f"estimator {what} column {nm!r} is not in the grid's union predictors "
                f"{tuple(union)} — estimator columns must ride the union tensor the "
                "contraction already has")
        mask[union.index(nm)] = True
    return mask


def _fm_tail(sol, stats_n, col_sel, out_dtype, *, weights, se, nw_lags: int, min_months: int):
    """SpecSolve → (cs, per-weight FM summaries) with the estimator's SE
    family: ``"nw"`` is the incumbent aggregation, ``"iid"`` is lag 0,
    ``"cluster"`` the by-year clustered kernel (one summary, whatever the
    weight scheme)."""
    slopes = torch.where(col_sel[:, None, :], sol.beta[..., 1:],
                         torch.full_like(sol.beta[..., 1:], float("nan")))
    cs = CSRegressionResult(
        slopes=slopes.to(out_dtype),
        intercept=sol.beta[..., 0].to(out_dtype),
        r2=sol.r2.to(out_dtype),
        n_obs=stats_n.to(out_dtype),
        month_valid=sol.month_valid,
    )
    if se == "cluster":
        fm = fm_cluster_summary(cs, min_months=min_months)
        return cs, tuple(fm for _ in weights)
    lags = 0 if se == "iid" else nw_lags
    return cs, tuple(fama_macbeth_summary(cs, nw_lags=lags, min_months=min_months, weight=w)
                     for w in weights)


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy().copy()


def run_estimator_grid_weights(
    estimator: Estimator,
    y,
    x,
    universe_masks: Dict[str, object],
    grid,
    weights: Tuple[str, ...],
    firm_chunk: Optional[int] = None,
    row_weights=None,
    precision: Optional[str] = None,
    factorize: Optional[str] = None,
    pair_pad: Optional[int] = None,
    fe_codes: Optional[Dict[str, object]] = None,
    device=None,
):
    """Run a whole spec grid under one non-OLS estimator.

    ``y`` (T, N) and ``x`` (T, N, P, the grid's union columns in order) run
    where they lie when they are tensors and ``device`` is None (as
    ``run_spec_grid_weights`` does); numpy inputs go to ``device`` (``None``
    → the GPU). Returns ``(Dict[weight -> SpecGridResult], disclosures)`` —
    ``run_spec_grid_weights``' result shape (``referee_specs`` always empty:
    estimator cells disclose, never referee) plus the per-spec disclosure
    arrays (``deficient_months``; absorb adds ``absorb_iters`` and
    ``absorb_converged``). ``fe_codes`` maps FE names → (T, N) int code
    arrays (absorb only). ``precision``/``factorize``/``pair_pad``/
    ``row_weights`` are ``run_spec_grid_weights``'."""
    est = estimator
    if est.kind == "ols":
        raise ValueError("kind='ols' is the incumbent grid path — call run_spec_grid_weights "
                         "(the engine routes it there)")
    precision = resolve_gram_precision(precision)
    factorize = resolve_gram_factorize(factorize)
    guard = _guard.guard_active()
    dev = y.device if isinstance(y, torch.Tensor) and device is None else resolve_device(device)
    y = torch.as_tensor(y, device=dev)
    x = torch.as_tensor(x, device=dev)
    p = x.shape[-1]
    names = list(universe_masks)
    universes = torch.stack([torch.as_tensor(universe_masks[nm], device=dev).to(torch.bool)
                             for nm in names])
    t = y.shape[0]
    union = tuple(grid.union_predictors)
    uidx_np = grid.universe_index(names)
    col_sel_np = grid.column_selector()
    window_np = grid.window_masks(t)
    s_specs = int(col_sel_np.shape[0])
    if row_weights is not None:
        row_weights = torch.as_tensor(row_weights, device=dev).to(x.dtype)

    # --- per-kind column blocks -----------------------------------------
    ones = np.ones((s_specs, 1), bool)
    codes_a = codes_b = None
    ga = gb = 1
    n_fe = 0
    col_sel_solve = col_sel_np
    aux_sel_np = np.concatenate([ones, col_sel_np], axis=1)   # placeholder
    col_sel_contract = col_sel_np
    if est.kind == "fwl":
        ctrl = _positions(union, est.controls, "control")
        col_sel_contract = col_sel_np | ctrl[None, :]
        col_sel_solve = col_sel_np & ~ctrl[None, :]
        aux_sel_np = np.concatenate([ones, np.broadcast_to(ctrl, col_sel_np.shape)], axis=1)
    elif est.kind == "iv":
        endog = _positions(union, est.endog, "endogenous")
        inst = _positions(union, est.instruments, "instrument")
        if (endog & inst).any():
            raise ValueError("a column cannot be both endogenous and an instrument")
        col_sel_contract = col_sel_np | inst[None, :]
        aux_sel_np = np.concatenate([ones, (col_sel_np & ~endog[None, :]) | inst[None, :]],
                                    axis=1)
    elif est.kind == "absorb":
        fe_codes = fe_codes or {}
        missing = [nm for nm in est.absorb if nm not in fe_codes]
        if missing:
            raise KeyError(f"absorb FE codes not supplied for {missing} — pass "
                           "fe_codes={name: (T, N) int codes}")
        n_fe = len(est.absorb)
        ca = np.asarray(fe_codes[est.absorb[0]])
        ga = int(ca.max()) + 1
        codes_a = torch.as_tensor(ca, device=dev).to(torch.int64)
        if n_fe == 2:
            cb = np.asarray(fe_codes[est.absorb[1]])
            gb = int(cb.max()) + 1
            codes_b = torch.as_tensor(cb, device=dev).to(torch.int64)
        else:
            codes_b = torch.zeros_like(codes_a)
    sel_aug_np = np.concatenate([ones, col_sel_solve], axis=1)

    # --- contraction plan (the factorization composes for the Gram kinds)
    use_fact = False
    if est.kind in ("fwl", "iv", "pooled") and factorize != "off":
        k_unique = int(unique_pairs(uidx_np, col_sel_contract)[0].shape[0])
        use_fact = factorize == "on" or k_unique < s_specs
    CONTRACTIONS["specs_solved"] += s_specs
    window = torch.as_tensor(window_np, device=dev)
    uidx = torch.as_tensor(uidx_np, device=dev)
    col_sel = torch.as_tensor(col_sel_solve, device=dev)
    if use_fact:
        uidx_u, col_sel_u, pair_idx = unique_pairs(uidx_np, col_sel_contract, pad_to=pair_pad)
        CONTRACTIONS["pairs_unique"] += k_unique
        CONTRACTIONS["pairs_contracted"] += int(uidx_u.shape[0])
        pair_stats = contract_spec_grams(
            y, x, universes, torch.as_tensor(uidx_u, device=dev),
            torch.as_tensor(col_sel_u, device=dev), None, firm_chunk=firm_chunk,
            row_weights=row_weights, precision=precision)
        stats = expand_window_stats(
            pair_stats, torch.as_tensor(pair_idx, device=dev, dtype=torch.long), window)
    else:
        CONTRACTIONS["specs_contracted"] += s_specs
        stats = contract_spec_grams(y, x, universes, uidx,
                                    torch.as_tensor(col_sel_contract, device=dev), window,
                                    firm_chunk=firm_chunk, row_weights=row_weights,
                                    precision=precision)

    # cutoffs at the eps the stats were CONTRACTED in
    data_eps = BF16_EPS if precision == "bf16" else float(torch.finfo(x.dtype).eps)
    contracted_eps = BF16_EPS if precision == "bf16" else None
    sel_aug = torch.as_tensor(sel_aug_np, device=dev)
    aux_sel = torch.as_tensor(aux_sel_np, device=dev)

    disclosures: Dict[str, object] = {"estimator": est.label, "kind": est.kind,
                                      "se_family": est.se}
    results: Dict[str, SpecGridResult] = {}
    if est.kind == "pooled":
        res = pooled_fit(stats, sel_aug, est.se, data_eps,
                         panel=(y, x, universes, uidx, col_sel, window), row_weights=row_weights)
        if guard:
            _guard.record("specgrid.estimator_program", {
                "pooled_nonfinite_beta": _guard.nonfinite_count(
                    torch.where(sel_aug, res.beta, torch.zeros_like(res.beta)))})
        n_months = _host(res.n_months).astype(np.int64)
        mean_n = np.divide(_host(res.n_total).astype(float), np.maximum(n_months, 1),
                           where=n_months > 0, out=np.full(n_months.shape, np.nan))
        deficient = _host(res.deficient).astype(bool)
        disclosures["deficient_months"] = deficient.astype(np.int64)
        beta, tstat, se = (_host(a).astype(float) for a in (res.beta, res.tstat, res.se))
        nan_st = np.full((s_specs, t), np.nan)
        for w in weights:
            results[w] = SpecGridResult(
                slopes=np.full((s_specs, t, p), np.nan),
                intercept=np.broadcast_to(beta[:, 0][:, None], (s_specs, t)).copy(),
                r2=nan_st.copy(), n_obs=nan_st.copy(),
                month_valid=np.zeros((s_specs, t), bool),
                coef=beta[:, 1:].copy(), tstat=tstat[:, 1:].copy(), nw_se=se[:, 1:].copy(),
                mean_r2=_host(res.r2).astype(float), mean_n=mean_n, n_months=n_months,
                suspect_months=deficient.astype(np.int64), referee_specs=(),
            )
        return results, disclosures

    extra = ()
    if est.kind == "fwl":
        stats2, deficient = fwl_transform(stats, sel_aug | aux_sel, aux_sel, data_eps)
    elif est.kind == "iv":
        stats2, deficient = iv_transform(stats, sel_aug, aux_sel, data_eps)
    else:  # absorb
        n_cells, s_cells = contract_absorb_cells(
            y, x, universes, uidx, col_sel, window, stats.center, codes_a, codes_b,
            row_weights=row_weights, ga=ga, gb=gb)
        stats2, iters, delta = absorb_transform(stats, sel_aug, n_cells, s_cells, n_fe=n_fe,
                                                tol=float(est.absorb_tol),
                                                max_iter=int(est.absorb_iters))
        del n_cells, s_cells
        deficient = torch.zeros_like(stats2.n, dtype=torch.bool)
        extra = (iters, delta)

    sol, counters = solve_spec_stats(stats2, sel_aug, guard=guard,
                                     contracted_eps=contracted_eps)
    if est.kind == "iv":
        sol = sol._replace(r2=iv_r2(sol.beta, stats, sol.month_valid))
    suspect = sol.suspect | (deficient & sol.month_valid)
    cs, fms = _fm_tail(sol, stats2.n, col_sel, y.dtype, weights=weights, se=est.se,
                       nw_lags=grid.nw_lags, min_months=grid.min_months)
    if guard:
        counters = dict(counters)
        counters["transform_deficient_months"] = deficient.sum()
        _guard.record("specgrid.estimator_program", counters)
    suspect_months = _host(suspect).sum(axis=1).astype(np.int64)
    disclosures["deficient_months"] = suspect_months
    if est.kind == "absorb":
        iters, delta = (_host(a) for a in extra)
        month_valid = _host(cs.month_valid).astype(bool)
        disclosures["absorb_iters"] = np.where(month_valid, iters, 0).max(axis=1).astype(
            np.int64)
        disclosures["absorb_converged"] = ((delta <= est.absorb_tol) | ~month_valid).all(axis=1)
    leaves = [_host(a) for a in cs]
    for w, fm in zip(weights, fms):
        results[w] = SpecGridResult(
            *(a.copy() for a in leaves), _host(fm.coef), _host(fm.tstat), _host(fm.nw_se),
            _host(fm.mean_r2), _host(fm.mean_n), _host(fm.n_months), suspect_months.copy(), (),
        )
    return results, disclosures
