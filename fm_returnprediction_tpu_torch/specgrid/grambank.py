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
- an ESTIMATOR query (``estimator_query``) — the FWL Schur complement, the
  IV two-solve projection, OLS under the ``iid``/``cluster`` FM tails, or
  the pooled fit under its month-separable SE families
  (``estimators.BANK_POOLED_SE``), all transforms of the banked stats,

all in O(T·Q²) work per pair, without touching the ``(T, N, P)`` panel
(absorbed FE needs FE-cell stats the bank does not hold, and the firm and
White pooled meats need the panel's residuals: both raise).
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

A bank persists on the registry's artifact plane (``save_bank``,
``load_bank``): ``artifacts/gram_bank/<bank_key>/bank.npz``. The key is the
reference's (data provenance, pair selectors, month axis, dtype,
precision) with its two numerics terms replaced: the reference's
``gram_route`` (one of several contraction routes) and its x64 flag (which
changes the banked numbers) become the contraction's DEVICE type. The port
has one contraction per device, and the card's K2 and the CPU's plain
version sum in different orders, so a bank contracted on one is another
entry than a bank contracted on the other; the torch version stands in
the entry's meta where the reference keeps x64.
"""

from __future__ import annotations

import hashlib
import io
import json
import tempfile
import warnings
from pathlib import Path
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
    BF16_EPS,
    _solve_and_aggregate,
    expand_window_stats,
    solve_spec_stats,
)

__all__ = [
    "BankQueryResult",
    "GramBank",
    "bank_key",
    "bootstrap_query",
    "build_bank",
    "estimator_query",
    "ingest_month",
    "load_bank",
    "save_bank",
    "scenario_query",
    "window_query",
]

BANK_NAME = "gram_bank"
BANK_FILE = "bank.npz"
#: bump when the banked-array layout changes: an old bank must read as a
#: miss to a new process, never as a half-compatible hit
BANK_SCHEMA = 1

_ARRAY_FIELDS = ("gram", "moment", "n", "ysum", "yy", "center",
                 "uidx", "col_sel", "months")


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


def _pairs_digest(uidx: np.ndarray, col_sel: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(uidx, np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(col_sel, bool)).tobytes())
    return h.hexdigest()


def bank_key(
    fingerprint: str,
    union: Sequence[str],
    universes: Sequence[str],
    uidx: np.ndarray,
    col_sel: np.ndarray,
    dtype: str,
    months: np.ndarray,
    precision: str,
    *,
    device: str,
) -> str:
    """Content address of one bank entry: data provenance + pair selectors
    + MONTH AXIS + contraction numerics (the device type and the
    precision). Anything that changes the banked numbers changes the key;
    the month digest keeps an ``ingest_month``-grown bank from replacing
    its parent at the parent's address."""
    payload = json.dumps(
        {
            "schema": BANK_SCHEMA,
            "fingerprint": str(fingerprint),
            "union": list(union),
            "universes": list(universes),
            "pairs": _pairs_digest(uidx, col_sel),
            "months": hashlib.sha256(
                np.ascontiguousarray(np.asarray(months, np.int64)).tobytes()
            ).hexdigest(),
            "dtype": str(dtype),
            "device": str(device),
            "precision": precision,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


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
              "device": dev.type, "nw_lags": int(space.nw_lags),
              "min_months": int(space.min_months)},
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


# -- persistence (registry artifact plane) -----------------------------------


def save_bank(bank: GramBank, registry=None) -> Optional[Path]:
    """Publish the bank as a registry artifact
    (``artifacts/gram_bank/<key>/bank.npz`` and its manifest-bearing meta).
    Returns the entry dir, or None when the registry is off or the write
    failed (banking is an accelerant, never a correctness gate)."""
    from fm_returnprediction_tpu_torch.registry import artifacts as _artifacts
    from fm_returnprediction_tpu_torch.registry.store import active_registry

    registry = registry or active_registry()
    if registry is None:
        return None
    key = bank_key(bank.meta.get("fingerprint", "adhoc"), bank.union, bank.universes,
                   bank.uidx, bank.col_sel, bank.dtype, bank.months,
                   bank.meta.get("precision", "highest"), device=bank.meta.get("device", "cuda"))
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / BANK_FILE
        buf = io.BytesIO()
        np.savez(buf, **{f: getattr(bank, f) for f in _ARRAY_FIELDS})
        path.write_bytes(buf.getvalue())
        return _artifacts.put_files(
            BANK_NAME, key, [path], registry=registry,
            meta={
                "bank_schema": BANK_SCHEMA,
                "union": list(bank.union),
                "universes": list(bank.universes),
                "pair_labels": [list(p) for p in bank.pair_labels],
                "dtype": bank.dtype,
                "n_pairs": bank.n_pairs,
                "n_months": bank.n_months,
                "torch": torch.__version__,
                "bank_meta": dict(bank.meta),
            },
        )


def load_bank(
    fingerprint: str,
    union: Sequence[str],
    universes: Sequence[str],
    uidx: np.ndarray,
    col_sel: np.ndarray,
    dtype: str,
    months: np.ndarray,
    precision: Optional[str] = None,
    registry=None,
    *,
    device=None,
) -> Optional[GramBank]:
    """Fetch the bank for this exact (data, pairs, month axis, device,
    precision) address, or None on any miss: no registry, no entry, a
    schema skew, or corruption (warned; the caller re-contracts).
    ``device`` (``None`` → the GPU) is the device the caller would
    contract on; ``precision`` follows ``FMRP_GRAM_PRECISION`` when None."""
    from fm_returnprediction_tpu_torch import telemetry
    from fm_returnprediction_tpu_torch.registry import artifacts as _artifacts
    from fm_returnprediction_tpu_torch.registry import integrity
    from fm_returnprediction_tpu_torch.registry.store import active_registry

    registry = registry or active_registry()
    if registry is None:
        return None
    device_type = resolve_device(device).type
    precision = resolve_gram_precision(precision)
    key = bank_key(fingerprint, union, universes, uidx, col_sel, dtype, months, precision,
                   device=device_type)
    entry = _artifacts.get_entry_dir(BANK_NAME, key, registry=registry)
    if entry is None:
        return None
    meta = registry.read_meta(entry) or {}
    if meta.get("bank_schema") != BANK_SCHEMA:
        return None
    try:
        path = _artifacts.get_file(BANK_NAME, BANK_FILE, key, registry=registry)
        if path is None:
            return None
        with np.load(path) as z:
            arrays = {f: np.asarray(z[f]) for f in _ARRAY_FIELDS}
    except (integrity.CorruptArtifactError, OSError, KeyError, ValueError) as exc:
        warnings.warn(f"gram bank {key} unreadable ({exc!r}); re-contracting",
                      stacklevel=2)
        return None
    telemetry.registry().counter(
        "fmrp_grambank_fetches_total",
        help="gram-bank registry fetches answered from banked stats",
    ).inc()
    return GramBank(
        **arrays,
        union=tuple(meta.get("union", list(union))),
        universes=tuple(meta.get("universes", list(universes))),
        pair_labels=tuple(tuple(p) for p in meta.get("pair_labels", [])),
        dtype=str(meta.get("dtype", dtype)),
        meta=dict(meta.get("bank_meta", {})),
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


def _estimator_selectors(bank: GramBank, est):
    """The (sel_aug (K, Q), aux_sel (K, Q), sel_solve (K, P)) selectors of
    an estimator on the bank's pairs (host numpy): the solved selection
    with its intercept, the kind's second block (FWL controls, IV
    instruments; intercept + the pair's columns for the other kinds, which
    ignore it) and the solved columns. Under IV the banked columns are
    read as structural ∪ excluded instruments. Every control, instrument and
    endogenous column must be banked in EVERY pair."""
    union = bank.union
    pos = {c: i for i, c in enumerate(union)}

    def _mask(names, what):
        m = np.zeros(len(union), bool)
        for nm in names:
            if nm not in pos:
                raise KeyError(f"estimator {what} column {nm!r} is not in the bank's union "
                               f"{tuple(union)}")
            m[pos[nm]] = True
        return m

    def _require_banked(m, what):
        lacking = [bank.pair_labels[k] for k in range(bank.n_pairs)
                   if not (m <= bank.col_sel[k]).all()]
        if lacking:
            raise ValueError(
                f"estimator {what} columns were not contracted into every banked pair — pairs "
                f"lacking them: {lacking}; rebuild the bank with the columns in each regressor "
                "set")

    col_sel = np.asarray(bank.col_sel, bool)
    ones = np.ones((bank.n_pairs, 1), bool)
    aux_sel = np.concatenate([ones, col_sel], axis=1)  # placeholder
    sel_solve = col_sel
    if est.kind == "fwl":
        ctrl = _mask(est.controls, "control")
        _require_banked(ctrl, "control")
        sel_solve = col_sel & ~ctrl[None, :]
        aux_sel = np.concatenate([ones, np.broadcast_to(ctrl, col_sel.shape)], axis=1)
    elif est.kind == "iv":
        inst = _mask(est.instruments, "instrument")
        endog = _mask(est.endog, "endogenous")
        _require_banked(inst, "instrument")
        _require_banked(endog, "endogenous")
        sel_solve = col_sel & ~inst[None, :]
        aux_sel = np.concatenate([ones, (sel_solve & ~endog[None, :]) | inst[None, :]], axis=1)
    return np.concatenate([ones, sel_solve], axis=1), aux_sel, sel_solve


def _bank_eps(bank: GramBank):
    """(data_eps, contracted_eps): the cutoffs at the eps the stats were
    CONTRACTED in — bf16's for a bf16 bank (whose stats are float32), the
    bank dtype's otherwise, where the solve's own eps applies. The stats
    are transformed and solved at their own dtype (``estimators.grid``)."""
    if str(bank.meta.get("precision", "highest")) == "bf16":
        return BF16_EPS, BF16_EPS
    return float(np.finfo(np.dtype(bank.dtype)).eps), None


def _bank_estimator_program(stats: SpecGramStats, sel_aug, aux_sel, col_sel, window, *,
                            kind: str, se: str, nw_lags: int, min_months: int,
                            weights: Tuple[str, ...], data_eps: float, contracted_eps):
    """Window-mask the banked stats, run the kind's Gram-stat transform
    (FWL Schur complement / IV two-solve / pooled month sum — never the
    panel), then the padded solve + SE-family tail. The estimator twin of
    ``_bank_query_program``; the (T, N, P) panel never appears."""
    from fm_returnprediction_tpu_torch.specgrid.estimators.cluster import pooled_fit
    from fm_returnprediction_tpu_torch.specgrid.estimators.fwl import fwl_transform
    from fm_returnprediction_tpu_torch.specgrid.estimators.grid import _fm_tail
    from fm_returnprediction_tpu_torch.specgrid.estimators.iv import iv_r2, iv_transform

    k = stats.gram.shape[0]
    masked = expand_window_stats(stats, torch.arange(k, device=stats.gram.device), window)
    if kind == "pooled":
        return pooled_fit(masked, sel_aug, se, data_eps, panel=None)
    if kind == "fwl":
        stats2, deficient = fwl_transform(masked, sel_aug | aux_sel, aux_sel, data_eps)
    elif kind == "iv":
        stats2, deficient = iv_transform(masked, sel_aug, aux_sel, data_eps)
    else:  # ols under a non-default SE family: the banked stats as they are
        stats2 = masked
        deficient = torch.zeros(masked.n.shape, dtype=torch.bool, device=masked.n.device)
    sol, _ = solve_spec_stats(stats2, sel_aug, contracted_eps=contracted_eps)
    if kind == "iv":
        sol = sol._replace(r2=iv_r2(sol.beta, masked, sol.month_valid))
    suspect = sol.suspect | (deficient & sol.month_valid)
    cs, fms = _fm_tail(sol, stats2.n, col_sel, stats.gram.dtype, weights=weights, se=se,
                       nw_lags=nw_lags, min_months=min_months)
    return cs, fms, suspect


def estimator_query(
    bank: GramBank,
    estimator,
    window=None,
    nw_lags: Optional[int] = None,
    min_months: Optional[int] = None,
    weight: str = "reference",
    device=None,
) -> Tuple[BankQueryResult, Dict[str, object]]:
    """One estimator cell for every banked pair, answered from the banked
    month-axis Gram stats on ``device`` (``None`` → the GPU) — the
    ``window_query`` of the estimator family. ``estimator`` is an
    ``Estimator``, a grammar string (``"fwl:beme+mom@iid"``), or None
    (``FMRP_SPECGRID_ESTIMATOR``/OLS through ``resolve_estimator``).
    Returns ``(result, disclosures)``; ``disclosures["col_sel"]`` is the (K,
    P) selection actually SOLVED (focal columns under FWL, structural under
    IV).

    - ``ols``/``fwl``/``iv``: exact Gram-stat transforms of the banked
      leaves, no panel contraction (``solve.contraction_counts`` and the K2
      launch counter stay flat);
    - ``pooled``: the month-separable SE families only
      (``estimators.BANK_POOLED_SE``); the firm/White/two-way meats need
      firm-level residuals the bank does not hold, so they raise
      ``ValueError``;
    - ``absorb``: raises ``ValueError`` — the alternating projections need
      per-(month, FE cell) stats the bank does not carry.

    Under IV the banked pair columns are read as structural ∪ EXCLUDED
    instruments: ``instruments`` leave the structural selection. Every
    control/instrument must be banked in EVERY pair (loud otherwise, naming
    the pairs)."""
    from fm_returnprediction_tpu_torch.specgrid.estimators.cluster import BANK_POOLED_SE
    from fm_returnprediction_tpu_torch.specgrid.estimators.core import resolve_estimator

    est = resolve_estimator(estimator)
    if est.kind == "absorb":
        raise ValueError(
            f"estimator {est.label!r} cannot be served from the gram bank: absorbed FE needs "
            "per-(month, FE-cell) sufficient stats the bank does not carry — run "
            "run_estimator_grid_weights on the panel instead")
    if est.kind == "pooled" and est.se not in BANK_POOLED_SE:
        raise ValueError(
            f"pooled SE family {est.se!r} needs firm-level residual scores the bank does not "
            f"hold; bank-servable families are {BANK_POOLED_SE} — run the grid route for the "
            "rest")
    nw_lags = _bank_int(bank, "nw_lags", nw_lags, 4)
    min_months = _bank_int(bank, "min_months", min_months, 10)
    sel_aug, aux_sel, sel_solve = _estimator_selectors(bank, est)
    data_eps, contracted_eps = _bank_eps(bank)

    dev = resolve_device(device)
    mask = _window_mask(bank, window)
    win = torch.as_tensor(np.broadcast_to(mask, (bank.n_pairs, bank.n_months)).copy(),
                          device=dev)
    out = _bank_estimator_program(
        bank.stats(dev), torch.as_tensor(sel_aug, device=dev),
        torch.as_tensor(aux_sel, device=dev), torch.as_tensor(sel_solve, device=dev), win,
        kind=est.kind, se=est.se, nw_lags=nw_lags, min_months=min_months,
        weights=(str(weight),), data_eps=data_eps, contracted_eps=contracted_eps)
    disclosures: Dict[str, object] = {"estimator": est.label, "kind": est.kind,
                                      "se_family": est.se, "col_sel": sel_solve}
    k, t, p = bank.n_pairs, bank.n_months, len(bank.union)
    if est.kind == "pooled":
        res = out
        deficient = _host(res.deficient).astype(bool)
        n_months = _host(res.n_months).astype(np.int64)
        disclosures["deficient_months"] = deficient.astype(np.int64)
        nan_kt = np.full((k, t), np.nan)
        result = BankQueryResult(
            slopes=np.full((k, t, p), np.nan), r2=nan_kt.copy(), n_obs=nan_kt.copy(),
            month_valid=np.zeros((k, t), bool),
            coef=_host(res.beta[:, 1:]).astype(float),
            tstat=_host(res.tstat[:, 1:]).astype(float),
            nw_se=_host(res.se[:, 1:]).astype(float),
            mean_r2=_host(res.r2).astype(float),
            mean_n=np.divide(_host(res.n_total).astype(float), np.maximum(n_months, 1),
                             where=n_months > 0, out=np.full(n_months.shape, np.nan)),
            n_months=n_months,
            suspect_months=deficient.astype(np.int64),
        )
        return result, disclosures
    cs, fms, suspect = out
    fm = fms[0]
    suspect_months = _host(suspect).sum(axis=1).astype(np.int64)
    disclosures["deficient_months"] = suspect_months
    result = BankQueryResult(
        slopes=_host(cs.slopes), r2=_host(cs.r2), n_obs=_host(cs.n_obs),
        month_valid=_host(cs.month_valid), coef=_host(fm.coef), tstat=_host(fm.tstat),
        nw_se=_host(fm.nw_se), mean_r2=_host(fm.mean_r2), mean_n=_host(fm.mean_n),
        n_months=_host(fm.n_months), suspect_months=suspect_months,
    )
    return result, disclosures


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
    ``suspect_months`` carries the disclosure.

    ``estimator`` (None: the OLS@NW path) sweeps the scenarios under a
    bank-servable estimator cell (:func:`estimator_query`); rows then carry
    ``estimator``/``se_family``, and bootstrap draws resample the
    transformed per-month slope series (pooled has no month series, so
    pooled with ``bootstrap > 1`` raises)."""
    windows = windows if windows is not None else {"full": None}
    label_of = label_of or {}
    rows = []
    union = bank.union
    est = None
    if estimator is not None:
        from fm_returnprediction_tpu_torch.specgrid.estimators.core import resolve_estimator

        est = resolve_estimator(estimator)
        if est.kind == "pooled" and bootstrap > 1:
            raise ValueError("pooled estimator cells produce no per-month slope series to "
                             "resample — bootstrap must be 1")
    for win_name, window in windows.items():
        for w in weights:
            est_sel = None
            if est is not None:
                point, disc = estimator_query(bank, est, window, weight=w, device=device)
                est_sel = disc["col_sel"]
                draw_stacks = None
                if bootstrap > 1:
                    idx = resample_matrix(bank.n_months, int(bootstrap), seed=seed)
                    mask = _window_mask(bank, window)
                    stacked = bootstrap_aggregate_pairs(
                        point.slopes, point.r2, point.n_obs, point.month_valid & mask[None, :],
                        idx, _bank_int(bank, "nw_lags", None, 4),
                        _bank_int(bank, "min_months", None, 10), w, device=device)
                    draw_stacks = [tuple(leaf[k] for leaf in stacked)
                                   for k in range(bank.n_pairs)]
            elif bootstrap > 1:
                point, draw_stacks = bootstrap_query(bank, bootstrap, window, seed=seed,
                                                     weight=w, device=device)
            else:
                point = window_query(bank, window, weight=w, device=device)
                draw_stacks = None
            for k, (set_name, uni) in enumerate(bank.pair_labels):
                pos = np.flatnonzero(bank.col_sel[k] if est_sel is None else est_sel[k])
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
                        if est is not None:
                            r["estimator"] = est.label
                            r["se_family"] = est.se
                        if bootstrap > 1:
                            r["draw"] = d
                        rows.append(r)
    return pd.DataFrame(rows)
