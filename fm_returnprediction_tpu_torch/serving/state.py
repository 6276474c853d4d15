"""Frozen, cache-serializable serving state for online E[r] queries.

The online service answers ``Ê[r]_{i,t} = ā_t + b̄_t' X_{i,t}``, the same
projection the batch forecast computes (``models.forecast``), one firm at a
time. Everything a query needs is fitted offline and frozen here:

- the LAGGED rolling-mean slopes and intercepts per month (month t's
  coefficients average months ≤ t−1 only);
- the featurization constants: the predictor order (``xvars``), the month
  vocabulary, and per-month support bounds ``[x_lo, x_hi]`` (the observed
  min/max of each predictor's valid cross-section);
- the per-month additive OLS sufficient statistics (``ops.ols.NormalStats``)
  and the raw per-month coefficient rows with their validity flags, from
  which a later month is ingested without a refit (``serving.ingest``).

The state is host numpy and persists through ``utils.cache.save_array_bundle``
in the reference package's layout (same array names, dtypes and digest), so
a state saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fm_returnprediction_tpu_torch.models.forecast import fit_forecast_artifacts
from fm_returnprediction_tpu_torch.models.lewellen import FIGURE1_VARS
from fm_returnprediction_tpu_torch.ops.ols import CSRegressionResult
from fm_returnprediction_tpu_torch.utils.cache import load_array_bundle, save_array_bundle

__all__ = ["ServingState", "build_serving_state", "build_serving_state_from_panel"]


@dataclasses.dataclass(frozen=True)
class ServingState:
    """Immutable fitted artifacts for the query path. All leaves numpy."""

    months: np.ndarray         # (T,) datetime64[ns] month vocabulary
    xvars: Tuple[str, ...]     # predictor order (featurization constant)
    coef: np.ndarray           # (T, Q) per-month [intercept, slopes]
    month_valid: np.ndarray    # (T,) bool
    slopes_bar: np.ndarray     # (T, P) lagged rolling-mean slopes
    intercept_bar: np.ndarray  # (T,)
    x_lo: np.ndarray           # (T, P) fitted support lower bound (−inf: none)
    x_hi: np.ndarray           # (T, P) fitted support upper bound (+inf: none)
    gram: np.ndarray           # (T, Q, Q) additive XᵀX
    moment: np.ndarray         # (T, Q)    additive Xᵀy
    n_obs: np.ndarray          # (T,)      valid rows per month, in the data dtype
    ysum: np.ndarray           # (T,)      Σy per month
    yy: np.ndarray             # (T,)      Σy² per month
    window: int = 120
    min_periods: int = 60
    solver: str = "qr"         # the per-month OLS solver ("qr", "lstsq", "normal")

    @property
    def n_months(self) -> int:
        return len(self.months)

    @property
    def n_predictors(self) -> int:
        return self.slopes_bar.shape[1]

    @property
    def dtype(self) -> np.dtype:
        return self.slopes_bar.dtype

    def have_coef(self) -> np.ndarray:
        """(T,) bool: month has a finite lagged coefficient mean."""
        return np.isfinite(self.intercept_bar) & np.all(np.isfinite(self.slopes_bar), axis=1)

    def month_index(self, month) -> int:
        """Resolve a month (int index or datetime-like) to its T-axis slot."""
        if isinstance(month, (int, np.integer)):
            idx = int(month)
            if not -self.n_months <= idx < self.n_months:
                raise KeyError(f"month index {idx} out of range")
            return idx % self.n_months
        hit = np.nonzero(self.months == np.datetime64(month, "ns"))[0]
        if not len(hit):
            raise KeyError(f"month {month!r} not in serving state")
        return int(hit[0])

    def save(self, path: Union[Path, str]) -> Path:
        arrays = {
            "months": self.months.astype("datetime64[ns]").astype(np.int64),
            "coef": self.coef,
            "month_valid": self.month_valid,
            "slopes_bar": self.slopes_bar,
            "intercept_bar": self.intercept_bar,
            "x_lo": self.x_lo,
            "x_hi": self.x_hi,
            "gram": self.gram,
            "moment": self.moment,
            "n_obs": self.n_obs,
            "ysum": self.ysum,
            "yy": self.yy,
        }
        meta = {"xvars": list(self.xvars), "window": self.window,
                "min_periods": self.min_periods, "solver": self.solver}
        return save_array_bundle(path, arrays, meta)

    @classmethod
    def load(cls, path: Union[Path, str]) -> "ServingState":
        arrays, meta = load_array_bundle(path)
        return cls(
            months=arrays["months"].astype("datetime64[ns]"),
            xvars=tuple(meta["xvars"]),
            coef=arrays["coef"],
            month_valid=arrays["month_valid"],
            slopes_bar=arrays["slopes_bar"],
            intercept_bar=arrays["intercept_bar"],
            x_lo=arrays["x_lo"],
            x_hi=arrays["x_hi"],
            gram=arrays["gram"],
            moment=arrays["moment"],
            n_obs=arrays["n_obs"],
            ysum=arrays["ysum"],
            yy=arrays["yy"],
            window=int(meta["window"]),
            min_periods=int(meta["min_periods"]),
            solver=str(meta["solver"]),
        )


def _support_bounds(x: torch.Tensor, mask: torch.Tensor):
    """Per-month observed min/max of each predictor's valid entries, on
    x's device. Per-predictor finiteness (not complete-case): a firm
    missing ROA still contributes its size to size's support. Empty cells
    open to ±inf so a query-time clip is a no-op there."""
    ok = mask[..., None] & torch.isfinite(x)
    inf = torch.full_like(x, float("inf"))
    lo = torch.where(ok, x, inf).amin(dim=1)
    hi = torch.where(ok, x, -inf).amax(dim=1)
    empty = ~ok.any(dim=1)
    lo = torch.where(empty, torch.full_like(lo, float("-inf")), lo)
    hi = torch.where(empty, torch.full_like(hi, float("inf")), hi)
    return lo, hi


def _merge_bounds(lo_a, hi_a, lo_b, hi_b):
    """Elementwise union of two fitted supports (numpy), respecting the
    ±inf "no observation" sentinels (observed bounds are always finite:
    the support only covers finite entries). Both sides empty stays
    open."""
    lo = np.minimum(np.where(np.isfinite(lo_a), lo_a, np.inf),
                    np.where(np.isfinite(lo_b), lo_b, np.inf))
    hi = np.maximum(np.where(np.isfinite(hi_a), hi_a, -np.inf),
                    np.where(np.isfinite(hi_b), hi_b, -np.inf))
    return (np.where(np.isfinite(lo), lo, -np.inf),
            np.where(np.isfinite(hi), hi, np.inf))


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def build_serving_state(
    y: torch.Tensor,
    x: torch.Tensor,
    mask: torch.Tensor,
    months: Optional[np.ndarray] = None,
    xvars: Optional[Sequence[str]] = None,
    window: int = 120,
    min_periods: int = 60,
    solver: str = "qr",
    cs=None,
) -> ServingState:
    """Fit a ``ServingState`` from a dense panel's tensors: y (T, N),
    x (T, N, P), mask (T, N) bool, all on one device. Pass ``cs`` (numpy
    or tensor leaves) to reuse an already computed batched OLS, e.g. a
    ``subset_sweep`` entry's; otherwise ``solver`` (``"qr"``, ``"lstsq"``
    or ``"normal"``) fits it, and the state keeps the name. Only
    (T, ·)-sized results leave the device."""
    mask = torch.as_tensor(mask, device=y.device)
    if cs is not None:
        cs = CSRegressionResult(*(torch.as_tensor(a, device=y.device) for a in cs))
    art = fit_forecast_artifacts(y, x, mask, window=window,
                                 min_periods=min_periods, solver=solver, cs=cs)
    lo, hi = _support_bounds(x, mask)
    t = art.coef.shape[0]
    if months is None:
        months = np.arange(t).astype("datetime64[M]").astype("datetime64[ns]")
    if xvars is None:
        xvars = tuple(f"x{k}" for k in range(x.shape[-1]))
    return ServingState(
        months=np.asarray(months).astype("datetime64[ns]"),
        xvars=tuple(xvars),
        coef=_host(art.coef),
        month_valid=_host(art.month_valid),
        slopes_bar=_host(art.slopes_bar),
        intercept_bar=_host(art.intercept_bar),
        x_lo=_host(lo),
        x_hi=_host(hi),
        gram=_host(art.stats.gram),
        moment=_host(art.stats.moment),
        n_obs=_host(art.stats.n),
        ysum=_host(art.stats.ysum),
        yy=_host(art.stats.yy),
        window=window,
        min_periods=min_periods,
        solver=solver,
    )


def build_serving_state_from_panel(
    panel,
    subset_mask,
    return_col: str = "retx",
    xvars: Optional[Sequence[str]] = None,
    window: int = 120,
    min_periods: int = 60,
    solver: str = "qr",
    cs=None,
) -> ServingState:
    """Fit the serving state from a pipeline ``DensePanel``: the figure's
    5-variable model over one subset, matching the decile-table forecast
    route cell for cell."""
    if xvars is None:
        xvars = list(FIGURE1_VARS.keys())
    return build_serving_state(
        panel.var(return_col), panel.select(xvars), subset_mask,
        months=panel.months, xvars=xvars, window=window,
        min_periods=min_periods, solver=solver, cs=cs,
    )
