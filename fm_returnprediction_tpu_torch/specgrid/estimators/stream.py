"""Streaming circular block bootstrap: constant memory in the draw count.

``specgrid.boot`` materializes one ``(D, P)`` coefficient row per draw,
fine at D = 1000 and hostile at D = 10⁶ or when draws come from several
workers. This module keeps the SAME draw semantics — circular moving-block
month resamples, one generator per ``(seed, draw)``
(``engine.block_bootstrap_months``, numpy, so the draws are the
reference's bit for bit) — but folds each chunk of draws into Welford
sufficient statistics ``(count, mean, M2)`` per coefficient as soon as it
is aggregated (``boot.bootstrap_aggregate_pairs`` on ``device``):

- ``extend(total)`` is RESUMABLE: draws are indexed, so growing 1 000 draws
  to 10 000 aggregates only the new 9 000;
- ``merge(other)`` is the parallel (Chan) moment combine: two accumulators
  over disjoint draw ranges merge as if one pass had seen every draw;
- draw 0 is the POINT estimate (never resampled): it goes through the same
  aggregation (the identity gather) and is held out of the moments.

NaN draw cells (a resample can drop a predictor below ``min_months``) are
skipped per element: counts are per coefficient.

The aggregation is plain torch (the reference's is a vmapped XLA program,
no Pallas kernel); the moments are host numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.specgrid.boot import bootstrap_aggregate_pairs

__all__ = ["StreamingBootstrap"]


class StreamingBootstrap:
    """Online moment accumulator over circular block-bootstrap draws of a
    bank of (T, P) slope series.

    ``slopes`` (K, T, P), ``r2``/``n_obs``/``month_valid`` (K, T) — the
    per-month leaves of K cells (one cell: ``K=1``). The aggregation knobs
    mirror the grid's (``nw_lags``/``min_months``/``weight``); every chunk
    aggregates on ``device`` (``None`` → the GPU)."""

    def __init__(self, slopes, r2, n_obs, month_valid, *, nw_lags: int = 4,
                 min_months: int = 10, weight: str = "reference", seed: int = 0,
                 block: Optional[int] = None, chunk: int = 256, device=None):
        self._series = (np.asarray(slopes), np.asarray(r2), np.asarray(n_obs),
                        np.asarray(month_valid, bool))
        k, t, p = self._series[0].shape
        self._t = t
        self._agg = dict(nw_lags=int(nw_lags), min_months=int(min_months), weight=str(weight),
                         device=resolve_device(device))
        self._seed = int(seed)
        self._block = block
        self._chunk = max(int(chunk), 1)
        self.count = np.zeros((k, p), np.int64)
        self.mean = np.zeros((k, p), float)
        self.m2 = np.zeros((k, p), float)
        self.draws_done = 0  # resampled draws folded in (draw ids 1..done)
        # draw 0 ≡ point: the identity gather through the SAME aggregator
        point = bootstrap_aggregate_pairs(*self._series, np.arange(t)[None, :], **self._agg)
        self.point = point[0][:, 0, :]                     # (K, P)
        self.point_tstat = point[1][:, 0, :]

    def _fold(self, coef: np.ndarray) -> None:
        """Welford batch update from a (K, D, P) chunk of draw rows."""
        finite = np.isfinite(coef)
        n_b = finite.sum(axis=1)                            # (K, P)
        if not n_b.any():
            return
        z = np.where(finite, coef, 0.0)
        mean_b = np.divide(z.sum(axis=1), n_b, where=n_b > 0, out=np.zeros_like(self.mean))
        dev = np.where(finite, coef - mean_b[:, None, :], 0.0)
        m2_b = (dev * dev).sum(axis=1)
        n_a, mean_a, m2_a = self.count, self.mean, self.m2
        n_ab = n_a + n_b
        delta = mean_b - mean_a
        frac = np.divide(n_b, n_ab, where=n_ab > 0, out=np.zeros_like(self.mean))
        self.mean = mean_a + delta * frac
        self.m2 = m2_a + m2_b + delta * delta * n_a * frac
        self.count = n_ab

    def extend(self, total_draws: int) -> "StreamingBootstrap":
        """Fold resampled draws until ``total_draws`` (EXCLUDING the point
        draw 0) have been seen, ``chunk`` draws an aggregation. Idempotent:
        draw ids already folded are never aggregated again."""
        from fm_returnprediction_tpu_torch.specgrid.engine import block_bootstrap_months

        while self.draws_done < total_draws:
            lo = self.draws_done + 1
            hi = min(total_draws, self.draws_done + self._chunk)
            idx = np.stack([block_bootstrap_months(self._t, d, seed=self._seed,
                                                   block=self._block)
                            for d in range(lo, hi + 1)])
            coef = bootstrap_aggregate_pairs(*self._series, idx, **self._agg)[0]  # (K, D, P)
            self._fold(coef)
            self.draws_done = hi
        return self

    def merge(self, other: "StreamingBootstrap") -> "StreamingBootstrap":
        """Parallel-combine another accumulator's moments into this one
        (Chan et al.'s pairwise update: exact, order-free). The two sides
        must cover DISJOINT draw ranges of the same seed for the merged
        moments to equal a single pass; that bookkeeping is the caller's."""
        n_a, n_b = self.count, other.count
        n_ab = n_a + n_b
        delta = other.mean - self.mean
        frac = np.divide(n_b, n_ab, where=n_ab > 0, out=np.zeros_like(self.mean))
        self.mean = self.mean + delta * frac
        self.m2 = self.m2 + other.m2 + delta * delta * n_a * frac
        self.count = n_ab
        self.draws_done = max(self.draws_done, other.draws_done)
        return self

    @property
    def std(self) -> np.ndarray:
        """Sample standard deviation of the draw distribution per (K, P)
        coefficient (ddof=1; NaN below 2 draws)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            var = np.where(self.count >= 2, self.m2 / np.maximum(self.count - 1, 1), np.nan)
        return np.sqrt(var)

    def summary(self) -> dict:
        """Host dict: point, draw mean/std/count — the streaming twin of the
        engine's materialized draw rows."""
        return {
            "point": self.point,
            "point_tstat": self.point_tstat,
            "boot_mean": self.mean.copy(),
            "boot_std": self.std,
            "boot_count": self.count.copy(),
            "draws_done": self.draws_done,
        }
