"""Rolling-origin coefficient paths on banked Gram stats — the scan route.

Per-month cross-sectional slopes are WINDOW-INDEPENDENT: each month's slope
solves from that month's own Gram (``solve.solve_spec_stats`` batches every
(pair, month) system at once), and an expanding or rolling estimation
window only selects WHICH months enter the Fama-MacBeth coefficient mean.
So the whole origin-indexed coefficient path — "estimate on months ≤ t,
for every t" — is ONE batched per-month solve plus a masked prefix sum:

    expanding:   path_t = Σ_{s≤t} v_s β_s / Σ_{s≤t} v_s
    rolling-W:   path_t = (C_t − C_{t−W}) / (c_t − c_{t−W}),  C = cumsum(vβ)

with ``v_s`` the month-validity indicator. The per-origin full-refit loop
(mask the banked stats at each origin, fresh solve, plain masked mean)
gives the same numbers up to summation order and is kept as the
differential ORACLE behind ``FMRP_BACKTEST_ROUTE=refit``.

Estimators: ``ols`` solves the banked stats as they are; ``fwl`` partials
the control block out of every month's Gram first
(``estimators.fwl.fwl_transform``, a Schur complement, so focal path
slopes are the full regression's). The kinds without a per-month slope
path (``iv``, ``pooled``, ``absorb``) are rejected loudly by
``resolve_estimator(allowed=...)``. Under FWL the intercept is exactly 0,
so predictions quote the partialled focal projection (``estimator_label``
discloses it).

Precision: the solve runs at the banked stats' dtype (float64 stats in
float64, float32 in float32), as ``specgrid.solve`` does; only stats
contracted in bfloat16 carry bf16's eps to the cutoffs
(``contracted_eps``). The JAX package upcasts float32 stats to float64
under its x64 flag, which the port does not have; at float64, where the
parity tests run, the two packages solve alike.

Prediction alignment: the coefficient path at origin t is applied to month
t+1's characteristics (``x`` already holds lagged characteristics), an
O(N·P) product per month that never forms a Gram, so the contraction
counters (``solve.contraction_counts``) stay flat across a whole backtest
sweep. The forecast product is a plain ``torch.einsum`` (an XLA product in
the JAX package, not a Pallas kernel).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.specgrid.estimators.core import resolve_estimator
from fm_returnprediction_tpu_torch.specgrid.estimators.fwl import fwl_transform
from fm_returnprediction_tpu_torch.specgrid.grambank import _bank_eps, _estimator_selectors
from fm_returnprediction_tpu_torch.specgrid.solve import expand_window_stats, solve_spec_stats

__all__ = [
    "BACKTEST_ROUTES",
    "BacktestPaths",
    "backtest_paths",
    "parse_scheme",
    "predict_er",
    "resolve_backtest_route",
    "resolve_quantiles",
    "resolve_schemes",
]

BACKTEST_ROUTES = ("auto", "scan", "refit")

#: estimator kinds with a per-month slope path an origin can roll over
BACKTEST_ESTIMATOR_KINDS = ("ols", "fwl")

DEFAULT_SCHEMES = "expanding,rolling120"
DEFAULT_QUANTILES = 10


def resolve_backtest_route(route: Optional[str] = None) -> str:
    """The path route: explicit argument > ``FMRP_BACKTEST_ROUTE`` env >
    ``"auto"`` (→ scan); ``"refit"`` runs the per-origin full-refit
    oracle."""
    if route is None:
        route = os.environ.get("FMRP_BACKTEST_ROUTE", "auto").strip().lower() or "auto"
    if route not in BACKTEST_ROUTES:
        raise ValueError(f"backtest route must be one of {BACKTEST_ROUTES}, got {route!r}")
    return route


def parse_scheme(text: str) -> Tuple[str, Optional[int]]:
    """Parse one window-scheme name: ``"expanding"`` (origin t estimates on
    all months ≤ t) or ``"rolling<W>"`` (the last W months ≤ t). Returns
    ``(name, window)`` with ``window=None`` for expanding."""
    name = (text or "").strip().lower()
    if name == "expanding":
        return name, None
    if name.startswith("rolling"):
        digits = name[len("rolling"):]
        if digits.isdigit() and int(digits) >= 1:
            return name, int(digits)
    raise ValueError(f"window scheme must be 'expanding' or 'rolling<W>' (W >= 1), "
                     f"got {text!r}")


def resolve_schemes(schemes=None) -> Tuple[Tuple[str, Optional[int]], ...]:
    """The scheme list: explicit argument (a comma string or an iterable of
    names) > ``FMRP_BACKTEST_SCHEMES`` env > ``"expanding,rolling120"``."""
    if schemes is None:
        schemes = os.environ.get("FMRP_BACKTEST_SCHEMES", DEFAULT_SCHEMES).strip() \
            or DEFAULT_SCHEMES
    if isinstance(schemes, str):
        names = [s for s in (p.strip() for p in schemes.split(",")) if s]
    else:
        names = [str(s).strip() for s in schemes]
    if not names:
        raise ValueError("at least one window scheme is required")
    parsed = tuple(parse_scheme(n) for n in names)
    if len({n for n, _ in parsed}) != len(parsed):
        raise ValueError(f"window schemes repeat a name: {names}")
    return parsed


def resolve_quantiles(n: Optional[int] = None) -> int:
    """Portfolio quantile count: explicit argument >
    ``FMRP_BACKTEST_QUANTILES`` env > 10 (deciles). Must be >= 2."""
    if n is None:
        n = int(os.environ.get("FMRP_BACKTEST_QUANTILES", DEFAULT_QUANTILES))
    n = int(n)
    if n < 2:
        raise ValueError(f"quantile count must be >= 2, got {n}")
    return n


class BacktestPaths(NamedTuple):
    """Origin-indexed coefficient paths for every banked pair (host numpy).
    ``beta`` is the per-month [intercept, slopes] solve (zeros on
    unselected columns and invalid months, so path sums never poison);
    ``path[k, t]`` the coefficient mean an estimation ending at origin t
    uses, NaN where fewer than ``min_months`` months entered. ``col_sel``
    is the selection actually solved (focal columns under FWL)."""

    beta: np.ndarray          # (K, T, Q)
    month_valid: np.ndarray   # (K, T) bool
    path: np.ndarray          # (K, T, Q)
    count: np.ndarray         # (K, T) months entering each origin's mean
    suspect: np.ndarray       # (K, T) bool, disclosed, never refereed
    col_sel: np.ndarray       # (K, P) bool
    scheme: str
    window: Optional[int]
    estimator_label: str
    route: str


def _transform_and_solve(stats, sel_aug, ctrl_aug, kind: str, data_eps: float,
                         contracted_eps):
    """The per-month estimation core of both routes: (optional) FWL Schur
    complement, then the grid route's padded solve."""
    deficient = torch.zeros(stats.n.shape, dtype=torch.bool, device=stats.n.device)
    if kind == "fwl":
        stats, deficient = fwl_transform(stats, sel_aug | ctrl_aug, ctrl_aug, data_eps)
    sol, _ = solve_spec_stats(stats, sel_aug, contracted_eps=contracted_eps)
    return sol, sol.suspect | (deficient & sol.month_valid)


def _shift_months(a: torch.Tensor, window: int) -> torch.Tensor:
    """``a`` moved ``window`` slots later along the month axis (axis 1),
    exact zeros shifted in."""
    t = a.shape[1]
    pad = torch.zeros((a.shape[0], min(window, t), *a.shape[2:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([pad, a[:, :t - pad.shape[1]]], dim=1)


def _backtest_path_program(stats, sel_aug, ctrl_aug, *, kind: str, window: Optional[int],
                           min_months: int, data_eps: float, contracted_eps):
    """The SCAN route: batched per-month solve over the banked stats, then
    the masked prefix-sum coefficient paths. The largest operand is the
    (K, T, Q, Q) bank."""
    sol, suspect = _transform_and_solve(stats, sel_aug, ctrl_aug, kind, data_eps,
                                        contracted_eps)
    beta, month_valid = sol.beta, sol.month_valid
    v = month_valid.to(beta.dtype)                              # (K, T)
    sum_b = torch.cumsum(beta * v[..., None], dim=1)            # (K, T, Q)
    cnt = torch.cumsum(v, dim=1)                                # (K, T)
    if window is not None:
        # rolling-W: C_t − C_{t−W}; early origins fall back to expanding over
        # the first min(t+1, W) months, then the min_months gate
        sum_b = sum_b - _shift_months(sum_b, window)
        cnt = cnt - _shift_months(cnt, window)
    have = cnt >= min_months
    path = torch.where(have[..., None], sum_b / torch.clamp_min(cnt, 1.0)[..., None],
                       torch.full_like(sum_b, float("nan")))
    return beta, month_valid, path, cnt, suspect


def _refit_origin_program(stats, sel_aug, ctrl_aug, window, *, kind: str, data_eps: float,
                          contracted_eps):
    """ONE origin of the REFIT oracle: mask the banked stats to the
    origin's estimation window (``expand_window_stats``, exact), solve them
    afresh and take a plain masked mean (an independent summation
    order)."""
    k = stats.gram.shape[0]
    masked = expand_window_stats(stats, torch.arange(k, device=stats.gram.device), window)
    sol, suspect = _transform_and_solve(masked, sel_aug, ctrl_aug, kind, data_eps,
                                        contracted_eps)
    v = sol.month_valid.to(sol.beta.dtype)
    cnt = v.sum(dim=1)                                          # (K,)
    mean = (sol.beta * v[..., None]).sum(dim=1) / torch.clamp_min(cnt, 1.0)[..., None]
    return mean, cnt, sol.beta, sol.month_valid, suspect


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def backtest_paths(
    bank,
    scheme: str = "expanding",
    estimator=None,
    min_months: Optional[int] = None,
    route: Optional[str] = None,
    device=None,
) -> BacktestPaths:
    """Origin-indexed coefficient paths for every banked pair under one
    window scheme, answered from the bank on ``device`` (``None`` → the
    GPU).

    ``scheme`` is ``"expanding"`` or ``"rolling<W>"``; ``estimator`` an
    ``Estimator`` or grammar string of a kind with a per-month slope path
    (``ols``/``fwl``; the rest raise); ``min_months`` gates origins whose
    window holds too few months (default: the bank's ``min_months``);
    ``route`` (:func:`resolve_backtest_route`): ``"scan"``/``"auto"`` run
    the prefix-sum program, ``"refit"`` the per-origin full-refit oracle."""
    est = resolve_estimator(estimator, allowed=BACKTEST_ESTIMATOR_KINDS)
    scheme_name, window = parse_scheme(scheme)
    effective = "refit" if resolve_backtest_route(route) == "refit" else "scan"
    min_months = int(bank.meta.get("min_months", 10) if min_months is None else min_months)
    dev = resolve_device(device)
    sel_aug, ctrl_aug, sel_solve = _estimator_selectors(bank, est)
    data_eps, contracted_eps = _bank_eps(bank)
    stats = bank.stats(dev)
    sel_t = torch.as_tensor(sel_aug, device=dev)
    ctrl_t = torch.as_tensor(ctrl_aug, device=dev)
    kw = dict(kind=est.kind, data_eps=data_eps, contracted_eps=contracted_eps)

    if effective == "scan":
        beta, month_valid, path, cnt, suspect = _backtest_path_program(
            stats, sel_t, ctrl_t, window=window, min_months=min_months, **kw)
        return BacktestPaths(
            beta=_host(beta), month_valid=_host(month_valid), path=_host(path),
            count=_host(cnt), suspect=_host(suspect), col_sel=sel_solve,
            scheme=scheme_name, window=window, estimator_label=est.label, route=effective)

    # refit oracle: one masked re-solve + re-aggregate per origin
    t, k, q = bank.n_months, bank.n_pairs, len(bank.union) + 1
    path = np.full((k, t, q), np.nan)
    count = np.zeros((k, t))
    for origin in range(t):
        lo = 0 if window is None else max(0, origin - window + 1)
        win = torch.zeros((k, t), dtype=torch.bool, device=dev)
        win[:, lo:origin + 1] = True
        mean, cnt, *_ = _refit_origin_program(stats, sel_t, ctrl_t, win, **kw)
        mean, cnt = _host(mean), _host(cnt)
        ok = cnt >= min_months
        path[:, origin][ok] = mean[ok]
        count[:, origin] = cnt
    # the per-month leaves of the full sample (window-independent): the last
    # expanding origin's, and one more full-sample solve for a rolling scheme
    full = torch.ones((k, t), dtype=torch.bool, device=dev)
    _, _, b, mv, sus = _refit_origin_program(stats, sel_t, ctrl_t, full, **kw)
    return BacktestPaths(
        beta=_host(b), month_valid=_host(mv), path=path, count=count, suspect=_host(sus),
        col_sel=sel_solve, scheme=scheme_name, window=window, estimator_label=est.label,
        route=effective)


def _predict_pair(paths: BacktestPaths, x: torch.Tensor, universe_mask, pair: int):
    """Ê[r] for one pair on ``x``'s device, left there: month t's forecast
    applies ``path[t − 1]`` to month t's characteristics, an O(N·P) product
    per month, never a Gram contraction. ``(er (T, N), er_valid (T, N))``."""
    dev = x.device
    coef_path = paths.path[pair]
    coef = torch.as_tensor(np.concatenate(
        [np.full((1, coef_path.shape[1]), np.nan, coef_path.dtype), coef_path[:-1]]),
        device=dev).to(x.dtype)
    col_sel = torch.as_tensor(paths.col_sel[pair], device=dev)
    mask = torch.as_tensor(universe_mask, device=dev).to(torch.bool)
    have = torch.isfinite(coef[:, 0])                           # (T,)
    # a row forecasts when its SOLVED predictors are all finite
    rows = mask & torch.all(torch.isfinite(x) | ~col_sel, dim=-1)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    er = coef[:, 0][:, None] + torch.einsum(
        "tnp,tp->tn", torch.where(rows[..., None] & col_sel, x, zero),
        torch.where(have[:, None], coef[:, 1:], zero))
    er_valid = rows & have[:, None]
    return torch.where(er_valid, er, torch.full_like(er, float("nan"))), er_valid


def predict_er(paths: BacktestPaths, x, universe_mask, pair: int, device=None):
    """Out-of-sample Ê[r] for one banked pair on ``device``: the
    coefficient path at origin t−1 applied to month t's (lagged)
    characteristics — strictly past information; month 0 has no origin and
    never forecasts. ``x`` holds the bank's union columns; returns host
    ``(er (T, N), er_valid (T, N))``."""
    dev = resolve_device(device)
    er, er_valid = _predict_pair(paths, torch.as_tensor(x, device=dev),
                                 torch.as_tensor(universe_mask, device=dev), pair)
    return _host(er), _host(er_valid)
