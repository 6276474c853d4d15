"""Backtest and portfolios — rolling-origin out-of-sample E[r] evaluation
and quantile portfolios on the in-memory Gram bank.

The estimation side never touches the ``(T, N, P)`` panel: every expanding
or rolling estimation origin is a masked re-aggregation of the banked
additive per-month Gram stats (``specgrid.grambank``), so the whole
origin-indexed coefficient path is one batched per-month solve plus a
masked prefix sum (``backtest.paths``; ``FMRP_BACKTEST_ROUTE=refit`` runs
the per-origin full-refit loop, the differential oracle).

- ``paths``     — coefficient paths (scan route + refit oracle), E[r] at
  t+1, the OLS/FWL estimators with loud rejection of the rest;
- ``portfolio`` — per-month quantile sorts on predicted E[r] (EW/VW,
  tie-deterministic), long-short spread, one-way turnover;
- ``evaluate``  — OOS R² against the expanding historical mean,
  Pearson/rank IC, NW inference and the block bootstrap over origins;
- ``space``     — the backtest cell space (scheme × estimator × set ×
  universe × weighting), index-addressable and lazy;
- ``sweep``     — the tile runner streaming cells to sinks, with the
  zero-panel-contraction proof;
- ``sinks``     — the spec-grid sinks plus the O(1) ``metrics`` aggregate.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from fm_returnprediction_tpu_torch.backtest.evaluate import (
    bootstrap_series,
    ic_series,
    ic_series_np,
    oos_r2,
    oos_r2_np,
    series_inference,
)
from fm_returnprediction_tpu_torch.backtest.paths import (
    BACKTEST_ROUTES,
    BacktestPaths,
    backtest_paths,
    parse_scheme,
    predict_er,
    resolve_backtest_route,
    resolve_quantiles,
    resolve_schemes,
)
from fm_returnprediction_tpu_torch.backtest.portfolio import PortfolioResult, quantile_sorts
from fm_returnprediction_tpu_torch.backtest.sinks import (
    BACKTEST_SINK_NAMES,
    MetricsSink,
    resolve_backtest_sink,
    resolve_backtest_sink_name,
)
from fm_returnprediction_tpu_torch.backtest.space import (
    BacktestCell,
    BacktestSpace,
    backtest_space,
)
from fm_returnprediction_tpu_torch.backtest.sweep import run_backtest, run_backtest_scenarios

__all__ = [
    "BACKTEST_ROUTES",
    "BACKTEST_SINK_NAMES",
    "BacktestCell",
    "BacktestPaths",
    "BacktestSpace",
    "MetricsSink",
    "PortfolioResult",
    "backtest_paths",
    "backtest_space",
    "bootstrap_series",
    "ic_series",
    "ic_series_np",
    "oos_r2",
    "oos_r2_np",
    "parse_scheme",
    "predict_er",
    "quantile_sorts",
    "resolve_backtest_route",
    "resolve_backtest_sink",
    "resolve_backtest_sink_name",
    "resolve_quantiles",
    "resolve_schemes",
    "run_backtest",
    "run_backtest_scenarios",
    "series_inference",
]
