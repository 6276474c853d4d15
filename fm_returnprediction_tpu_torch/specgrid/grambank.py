"""The Gram bank, in memory: per-month Gram sufficient stats of one panel.

A bank holds the UNWINDOWED per-(universe, col_sel)-pair, per-month Gram
stats of one panel — what ``contract_spec_grams(window=None)`` produces for
the factorized grid route — as host numpy leaves. Because every estimand
beyond the point estimate differs only in WHICH months enter the FM
aggregation, the banked ``(K, T, Q, Q)`` leaves answer

- a NEW WINDOW query — mask the month axis (``solve.expand_window_stats``,
  exact) and run the padded solve + FM tail (``solve._solve_and_aggregate``),
- a NEW BOOTSTRAP query — solve the slope series once, then the
  pairs-batched month-resample aggregation
  (``boot.bootstrap_aggregate_pairs``),

both in O(T·Q²) work per pair, without touching the ``(T, N, P)`` panel.
``ingest_month`` appends one month's cross-section by Gram additivity (one
O(N·Q²) monthly contraction). The rolling-origin backtest (``backtest``)
answers its whole sweep from one bank.

The contraction is the port's ``contract_spec_grams``: on the card the Gram
kernel K2 (``csrc/gram.cu``), on the CPU its plain version; there is one
contraction per device, so the bank records no contraction route.
``build_bank``, ``ingest_month`` and the queries run on ``device`` (``None``
→ the GPU); the bank itself stays on the host.

Bank queries have no QR referee (the panel is not there to re-solve
against): suspect months are DISCLOSED per pair (``suspect_months``).

Not ported yet: the bank's persistence on the registry's artifact plane
(``save_bank``, ``load_bank``, ``bank_key``; ROADMAP §A item 7) and the
estimator queries (``estimator_query``, ``scenario_query(estimator=...)``;
ROADMAP §A item 5).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from fm_returnprediction_tpu_torch.device import resolve_device
from fm_returnprediction_tpu_torch.specgrid.boot import (
    bootstrap_aggregate_pairs,
    resample_matrix,
)
from fm_returnprediction_tpu_torch.specgrid.grams import (
    SpecGramStats,
    contract_spec_grams,
    resolve_gram_precision,
    unique_pairs,
)
from fm_returnprediction_tpu_torch.specgrid.solve import (
    _solve_and_aggregate,
    expand_window_stats,
)

__all__ = [
    "BankQueryResult",
    "GramBank",
    "bootstrap_query",
    "build_bank",
    "ingest_month",
    "scenario_query",
    "window_query",
]


class GramBank(NamedTuple):
    """One panel's banked per-pair, per-month Gram stats (host numpy).

    ``gram``/``moment``/``n``/``ysum``/``yy`` are the UNWINDOWED
    ``SpecGramStats`` leaves over the K (set, universe) pairs; ``center``
    is the (T, P) per-month shift they were contracted against (the
    additivity anchor: ``ingest_month`` extends it one row per month).
    ``months`` carries the month labels window queries address, and
    ``pair_labels`` names each pair ``(set_name, universe_name)``."""

    gram: np.ndarray          # (K, T, Q, Q)
    moment: np.ndarray        # (K, T, Q)
    n: np.ndarray             # (K, T)
    ysum: np.ndarray          # (K, T)
    yy: np.ndarray            # (K, T)
    center: np.ndarray        # (T, P)
    uidx: np.ndarray          # (K,) universe row per pair
    col_sel: np.ndarray       # (K, P) bool
    months: np.ndarray        # (T,) int64 month labels
    union: Tuple[str, ...]    # union predictor column names (P)
    universes: Tuple[str, ...]  # universe names (U)
    pair_labels: Tuple[Tuple[str, str], ...]  # (set_name, universe) per pair
    dtype: str                # panel dtype the stats were contracted in
    meta: dict                # fingerprint, precision, nw_lags, min_months

    @property
    def n_pairs(self) -> int:
        return int(self.gram.shape[0])

    @property
    def n_months(self) -> int:
        return int(self.gram.shape[1])

    def stats(self, device=None) -> SpecGramStats:
        """The banked leaves as a ``SpecGramStats`` of tensors on
        ``device`` (``None`` → the GPU)."""
        dev = resolve_device(device)
        return SpecGramStats(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                               for a in (self.gram, self.moment, self.n, self.ysum,
                                         self.yy, self.center)))


def _space_pairs(space) -> Tuple[np.ndarray, np.ndarray, tuple]:
    """The (uidx, col_sel, pair_labels) of a ``CellSpace``'s (set,
    universe) pair product in pair-index order (set-major, the order
    ``cellspace.pair_index`` addresses)."""
    union = space.union_predictors
    pos = {c: i for i, c in enumerate(union)}
    uidx, col_sel, labels = [], [], []
    for set_name, cols in space.regressor_sets:
        sel = np.zeros(len(union), bool)
        for c in cols:
            sel[pos[c]] = True
        for u, uni in enumerate(space.universes):
            uidx.append(u)
            col_sel.append(sel)
            labels.append((set_name, uni))
    return np.asarray(uidx, np.int64), np.stack(col_sel), tuple(labels)


def _torch_dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _contract_pairs(y, x, universes, uidx: np.ndarray, col_sel: np.ndarray, dev,
                    firm_chunk, precision: str) -> SpecGramStats:
    """One ``window=None`` contraction over the distinct pairs, expanded
    back to every pair and copied to the host (numpy leaves)."""
    uidx_u, col_sel_u, pair_idx = unique_pairs(uidx, col_sel)
    stats = contract_spec_grams(
        y, x, universes, torch.as_tensor(uidx_u, device=dev),
        torch.as_tensor(col_sel_u, device=dev), None, firm_chunk=firm_chunk,
        precision=precision)
    host = [a.detach().cpu().numpy() for a in stats]
    return SpecGramStats(*(a[pair_idx] for a in host[:5]), host[5])


def build_bank(
    y,
    x,
    universe_masks: Dict[str, object],
    space,
    months: Optional[np.ndarray] = None,
    fingerprint: str = "adhoc",
    firm_chunk: Optional[int] = None,
    precision: Optional[str] = None,
    device=None,
) -> GramBank:
    """Contract one panel into a bank: ONE ``window=None`` contraction over
    the space's distinct (universe, col_sel) pairs (one K2 launch on the
    card). ``y`` (T, N) and ``x`` (T, N, P) in ``space.union_predictors``
    column order, ``universe_masks`` name → (T, N) bool, as numpy arrays or
    tensors; ``months`` defaults to ``0..T-1`` index labels; ``precision``
    follows ``FMRP_GRAM_PRECISION`` when None."""
    dev = resolve_device(device)
    precision = resolve_gram_precision(precision)
    uidx, col_sel, labels = _space_pairs(space)
    missing = [u for u in space.universes if u not in universe_masks]
    if missing:
        raise ValueError(f"universe masks missing for {missing}")
    y = torch.as_tensor(y, device=dev)
    x = torch.as_tensor(x, device=dev)
    universes = torch.stack([torch.as_tensor(universe_masks[u], device=dev).to(torch.bool)
                             for u in space.universes])
    stats = _contract_pairs(y, x, universes, uidx, col_sel, dev, firm_chunk, precision)
    t = int(y.shape[0])
    months = np.arange(t, dtype=np.int64) if months is None else np.asarray(months, np.int64)
    if months.shape != (t,):
        raise ValueError(f"months labels must be (T,) == ({t},), got {months.shape}")
    return GramBank(
        *stats, uidx=uidx, col_sel=col_sel, months=months,
        union=tuple(space.union_predictors), universes=tuple(space.universes),
        pair_labels=labels, dtype=_torch_dtype_name(x.dtype),
        meta={"fingerprint": str(fingerprint), "precision": precision,
              "nw_lags": int(space.nw_lags), "min_months": int(space.min_months)},
    )


def ingest_month(
    bank: GramBank,
    y_month,
    x_month,
    universe_masks_month: Dict[str, object],
    month: int,
    device=None,
) -> GramBank:
    """Append ONE month's cross-section to the bank by Gram additivity: a
    one-month contraction (one K2 launch on the card) extends every leaf
    one slot along the month axis.

    ``y_month`` (N,), ``x_month`` (N, P) in the bank's union column order,
    ``universe_masks_month`` name → (N,) bool for the bank's universes
    (numpy arrays or tensors). The
    month's center row is its masked column mean, what the full-panel
    contraction computes for that month."""
    if int(month) in set(int(m) for m in bank.months):
        raise ValueError(f"month {month} is already banked — ingest appends new months; "
                         "re-contract to replace one")
    dev = resolve_device(device)
    dtype = getattr(torch, bank.dtype)
    y1 = torch.as_tensor(y_month, device=dev).to(dtype)[None, :]
    x1 = torch.as_tensor(x_month, device=dev).to(dtype)[None]
    if x1.shape[2] != len(bank.union):
        raise ValueError(f"x_month has {x1.shape[2]} columns; the bank's union holds "
                         f"{len(bank.union)}")
    missing = [u for u in bank.universes if u not in universe_masks_month]
    if missing:
        raise ValueError(f"universe masks missing for {missing}")
    uni1 = torch.stack([
        torch.as_tensor(universe_masks_month[u], device=dev).to(torch.bool)[None]
        for u in bank.universes])                               # (U, 1, N)
    new = _contract_pairs(y1, x1, uni1, bank.uidx, bank.col_sel, dev, None,
                          bank.meta.get("precision", "highest"))

    def app(old, leaf):
        return np.concatenate([old, leaf], axis=1)

    return bank._replace(
        gram=app(bank.gram, new.gram), moment=app(bank.moment, new.moment),
        n=app(bank.n, new.n), ysum=app(bank.ysum, new.ysum), yy=app(bank.yy, new.yy),
        center=np.concatenate([bank.center, new.center], axis=0),
        months=np.concatenate([bank.months, np.asarray([int(month)], np.int64)]),
    )


def _window_mask(bank: GramBank, window) -> np.ndarray:
    """A query window as a (T,) bool month mask: None = full sample,
    ``(lo, hi)`` = half-open MONTH-LABEL range against ``bank.months``, or
    an explicit (T,) bool mask."""
    t = bank.n_months
    if window is None:
        return np.ones(t, bool)
    if isinstance(window, (tuple, list)) and len(window) == 2:
        lo, hi = window
        mask = (bank.months >= int(lo)) & (bank.months < int(hi))
        if not mask.any():
            # almost always label/position confusion: an all-NaN frame would
            # be a silent wrong answer
            raise ValueError(
                f"window ({lo}, {hi}) matches NO banked month labels (bank holds "
                f"[{bank.months.min()}, {bank.months.max()}]) — ranges address month "
                "LABELS, not positions; pass an explicit (T,) bool mask to select by "
                "position")
        return mask
    mask = np.asarray(window, bool)
    if mask.shape != (t,):
        raise ValueError(f"window mask must be ({t},), got {mask.shape}")
    return mask


class BankQueryResult(NamedTuple):
    """Host-side result of one bank query, pair-major (the bank's twin of
    ``SpecGridResult``, without the referee: suspect months are
    disclosed)."""

    slopes: np.ndarray        # (K, T, P) NaN on unselected columns
    r2: np.ndarray            # (K, T)
    n_obs: np.ndarray         # (K, T)
    month_valid: np.ndarray   # (K, T)
    coef: np.ndarray          # (K, P)
    tstat: np.ndarray         # (K, P)
    nw_se: np.ndarray         # (K, P)
    mean_r2: np.ndarray       # (K,)
    mean_n: np.ndarray        # (K,)
    n_months: np.ndarray      # (K,)
    suspect_months: np.ndarray  # (K,)


def _bank_query_program(stats: SpecGramStats, col_sel: torch.Tensor, window: torch.Tensor, *,
                nw_lags: int, min_months: int, weights: Tuple[str, ...]):
    """Window-mask the banked additive stats (``expand_window_stats`` with
    the identity gather, exact) and run the grid route's padded solve + FM
    tail. The (T, N, P) panel never appears."""
    k = stats.gram.shape[0]
    masked = expand_window_stats(stats, torch.arange(k, device=stats.gram.device), window)
    cs, fms, suspect, _ = _solve_and_aggregate(
        masked, col_sel, stats.gram.dtype, nw_lags=nw_lags, min_months=min_months,
        weights=tuple(weights), guard=False)
    return cs, fms, suspect


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def _bank_int(bank: GramBank, key: str, value: Optional[int], default: int) -> int:
    return int(bank.meta.get(key, default) if value is None else value)


def window_query(
    bank: GramBank,
    window=None,
    nw_lags: Optional[int] = None,
    min_months: Optional[int] = None,
    weight: str = "reference",
    device=None,
) -> BankQueryResult:
    """FM estimates for every banked pair under a NEW sample window,
    answered from the banked month-axis stats on ``device`` (mask + solve +
    aggregate; the panel is never read). ``window`` is None (full), a
    half-open ``(lo, hi)`` month-label range, or a (T,) bool mask."""
    nw_lags = _bank_int(bank, "nw_lags", nw_lags, 4)
    min_months = _bank_int(bank, "min_months", min_months, 10)
    dev = resolve_device(device)
    mask = _window_mask(bank, window)
    win = torch.as_tensor(np.broadcast_to(mask, (bank.n_pairs, bank.n_months)).copy(),
                          device=dev)
    cs, fms, suspect = _bank_query_program(
        bank.stats(dev), torch.as_tensor(bank.col_sel, device=dev), win,
        nw_lags=nw_lags, min_months=min_months, weights=(str(weight),))
    fm = fms[0]
    return BankQueryResult(
        slopes=_host(cs.slopes), r2=_host(cs.r2), n_obs=_host(cs.n_obs),
        month_valid=_host(cs.month_valid), coef=_host(fm.coef), tstat=_host(fm.tstat),
        nw_se=_host(fm.nw_se), mean_r2=_host(fm.mean_r2), mean_n=_host(fm.mean_n),
        n_months=_host(fm.n_months),
        suspect_months=_host(suspect).sum(axis=1).astype(np.int64),
    )


def bootstrap_query(
    bank: GramBank,
    draws: int,
    window=None,
    seed: int = 0,
    block: Optional[int] = None,
    nw_lags: Optional[int] = None,
    min_months: Optional[int] = None,
    weight: str = "reference",
    device=None,
):
    """Bootstrap draws for every banked pair under a (new) window: ONE bank
    solve for the slope series (:func:`window_query`), then ONE
    pairs-batched aggregation of every (pair, draw) on ``device``, on the
    spec-grid engine's circular block draws. Returns ``(point, draws_list)``
    where ``draws_list[k]`` is pair k's ``(coef (D-1, P), tstat, nw_se,
    mean_r2, mean_n, n_months)`` draw stack (draw 0, the point estimate, is
    ``point`` itself)."""
    if draws < 1:
        raise ValueError("draws counts the point estimate; must be >= 1")
    nw_lags = _bank_int(bank, "nw_lags", nw_lags, 4)
    min_months = _bank_int(bank, "min_months", min_months, 10)
    point = window_query(bank, window, nw_lags=nw_lags, min_months=min_months,
                         weight=weight, device=device)
    idx = resample_matrix(bank.n_months, int(draws), seed=seed, block=block)
    mask = _window_mask(bank, window)
    stacked = bootstrap_aggregate_pairs(
        point.slopes, point.r2, point.n_obs, point.month_valid & mask[None, :], idx,
        nw_lags, min_months, weight, device=device)
    return point, [tuple(leaf[k] for leaf in stacked) for k in range(bank.n_pairs)]


def scenario_query(
    bank: GramBank,
    windows: Optional[Dict[str, object]] = None,
    bootstrap: int = 1,
    seed: int = 0,
    weights: Sequence[str] = ("reference",),
    label_of: Optional[Dict[str, str]] = None,
    estimator=None,
    device=None,
) -> pd.DataFrame:
    """The scenarios path over banked stats: a tidy frame in the
    ``run_scenarios`` row schema (model/universe/window/nw_weight/
    predictor/coef/tstat/... plus ``draw`` when bootstrapped), answered per
    (window, weight, draw) from the bank on ``device`` with ZERO panel
    reads. No QR referee exists here, so ``refereed`` is always False and
    ``suspect_months`` carries the disclosure. ``estimator`` must be None:
    the bank's estimator queries are not ported yet (ROADMAP §A item 5)."""
    if estimator is not None:
        raise NotImplementedError(
            "bank estimator queries (scenario_query(estimator=...), estimator_query) are "
            "not ported yet (ROADMAP §A item 5)")
    windows = windows if windows is not None else {"full": None}
    label_of = label_of or {}
    rows = []
    union = bank.union
    for win_name, window in windows.items():
        for w in weights:
            if bootstrap > 1:
                point, draw_stacks = bootstrap_query(bank, bootstrap, window, seed=seed,
                                                     weight=w, device=device)
            else:
                point = window_query(bank, window, weight=w, device=device)
                draw_stacks = None
            for k, (set_name, uni) in enumerate(bank.pair_labels):
                pos = np.flatnonzero(bank.col_sel[k])
                for d in range(int(bootstrap)):
                    if d == 0:
                        coef, tstat, nw_se = point.coef[k], point.tstat[k], point.nw_se[k]
                        mean_r2, mean_n = float(point.mean_r2[k]), float(point.mean_n[k])
                        n_months = int(point.n_months[k])
                    else:
                        cd, td, nd, rd, ndm, md = draw_stacks[k]
                        coef, tstat, nw_se = cd[d - 1], td[d - 1], nd[d - 1]
                        mean_r2, mean_n = float(rd[d - 1]), float(ndm[d - 1])
                        n_months = int(md[d - 1])
                    for p in pos:
                        col = union[p]
                        r = {
                            "model": set_name,
                            "universe": uni,
                            "window": win_name,
                            "nw_weight": w,
                            "predictor": label_of.get(col, col),
                            "coef": float(coef[p]),
                            "tstat": float(tstat[p]),
                            "nw_se": float(nw_se[p]),
                            "mean_r2": mean_r2,
                            "mean_n": mean_n,
                            "n_months": n_months,
                            "refereed": False,
                            "suspect_months": int(point.suspect_months[k]),
                            "source": "bank",
                        }
                        if bootstrap > 1:
                            r["draw"] = d
                        rows.append(r)
    return pd.DataFrame(rows)
