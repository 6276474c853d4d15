"""Masked contraction of the dense panel into per-spec Gram statistics.

Per-month OLS sufficient statistics are ADDITIVE over firms, so every spec
cell is a weighted contraction of the SAME augmented design

    G_s[t] = Σ_n  w_s[t,n] · x̃[t,n,:] x̃[t,n,:]ᵀ ,  x̃ = [1 | X_union − c_t]

where ``w_s`` is the spec's 0/1 row validity (universe mask ∧ finite y ∧
finite selected predictors ∧ sample window), times the optional row
weights, and ``c_t`` a per-month column shift that decollinearizes the
intercept column. Non-finite entries of UNSELECTED columns enter as zero,
so each spec's selected block is exact and the rest is ignored by the
padded solve (``specgrid.solve``).

``contract_spec_grams`` takes one of two versions, chosen by where the
tensors lie:

- CUDA tensors go to the hand-written kernel (``csrc/gram.cu``, wrapper
  ``gram_contract_cuda``): the blocks of a month stream the panel through
  shared memory for all specs and build the weights there; float32 sums
  register tiles of every spec's block on the CUDA cores in plain IEEE
  float32 (4×4 tiles up to 32 columns; past 32 columns 8×8 tiles in
  warp-specialized blocks that stage and build a month's tiles once for
  every spec), float64 goes to the FP64 tensor cores (DMMA ``mma.sync``
  m16n8k8), bfloat16 operands to the tensor cores (``mma.sync`` with
  float32 sums, each spec's 0/1 weight a mask on the fragments, a row
  weight's product ``w·x̃`` split exactly into two bfloat16 parts). Past
  ``GRAM_TILE_FROM`` columns every operand type goes to the tile-pair
  kernel (``gram_tile_plan``): one launch at any width, a block a pair of
  64-column tiles of the augmented block, a month and a group of specs,
  each tile staged from x itself, after a pre-pass kernel folds every
  selected column's finiteness into the valid mask (``gram_fold_cuda``);
- CPU tensors take the plain version, a chunked masked einsum over firm
  slices (``contract_spec_grams_plain``).

There is no fallback between the two, and no counterpart of the reference's
``resolve_gram_route`` (its ``xla``/``pallas`` knob): the device decides.

Options, as in the reference:

- ``precision`` — ``"highest"`` (the storage dtype) or ``"bf16"``: x, y,
  the center and the row weights are rounded to bfloat16 once, ``x − c`` is
  formed and rounded in bfloat16, and the products ``w·x̃`` and every sum
  are float32. The stats come back float32 and carry bf16's eps to the
  solve's conditioning referee. ``FMRP_GRAM_PRECISION`` sets the default
  (``resolve_gram_precision``).
- ``window=None`` — the factorized route: no window term in validity; the
  solve applies each spec's window to the additive per-month stats
  (``solve.expand_window_stats``). ``unique_pairs`` collapses the spec axis
  to its distinct (universe, col_sel) pairs; ``FMRP_GRAM_FACTORIZE`` sets
  the policy (``resolve_gram_factorize``).
- ``row_weights`` — a non-negative, finite (T, N) weight multiplying each
  spec's 0/1 validity (the coreset route's importance weights): ``n``
  becomes Σw and every moment is weighted.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from fm_returnprediction_tpu_torch.cuda_build import check_status, kernel_function

__all__ = [
    "SpecGramStats",
    "auto_firm_chunk",
    "shared_center",
    "contract_spec_grams",
    "contract_spec_grams_plain",
    "GramTilePlan",
    "gram_contract_cuda",
    "gram_contract_plain",
    "gram_fold_cuda",
    "gram_fold_plain",
    "gram_launch_count",
    "gram_launch_fits",
    "gram_spec_chunk",
    "gram_tile_plan",
    "selection_words",
    "resolve_gram_factorize",
    "resolve_gram_precision",
    "split_stats",
    "unique_pairs",
]

# operand dtype → (the kernel's dtype code, its launch-key name)
_DTYPE_CODES = {torch.float32: (0, "f32"), torch.float64: (1, "f64"),
                torch.bfloat16: (2, "bf16")}
# upper-triangle entries of one launch of the float32 and bfloat16 kernels
# up to 32 columns (csrc/gram.cu)
GRAM_MAX_ENTRIES = 8192
# specs one launch of the float64 kernel, and of the float32 and bfloat16
# kernels past 32 columns, takes: the whole batch of any real call
GRAM_ONE_LAUNCH_SPECS = 65536

# the tile-pair kernel (csrc/gram.cu gram_tiles): augmented columns a tile,
# the most specs one block sums, and the union width from which it takes a
# call of each operand type (below it the one-launch kernels are faster;
# timed on an H100 by k2_crossover.py, PERF.md)
GRAM_TILE_COLS = 64
GRAM_TILE_SPECS = 3
GRAM_TILE_FROM = {torch.float32: 160, torch.float64: 128, torch.bfloat16: 160}
# shared memory one block of the kernels may take (csrc/gram.cu kSmemMax)
_SMEM_MAX = 227 * 1024

GRAM_PRECISIONS = ("highest", "bf16")
GRAM_FACTORIZE_MODES = ("auto", "on", "off")


def resolve_gram_precision(precision: Optional[str] = None) -> str:
    """The contraction precision: explicit argument > ``FMRP_GRAM_PRECISION``
    env > ``"highest"``."""
    if precision is None:
        precision = (os.environ.get("FMRP_GRAM_PRECISION", "highest").strip().lower()
                     or "highest")
    if precision not in GRAM_PRECISIONS:
        raise ValueError(f"gram precision must be one of {GRAM_PRECISIONS}, got {precision!r}")
    return precision


def resolve_gram_factorize(factorize: Optional[str] = None) -> str:
    """The month-axis factorization policy: explicit argument >
    ``FMRP_GRAM_FACTORIZE`` env > ``"auto"``. ``"on"`` contracts once per
    unique (universe, col_sel) pair without the window term and derives
    each spec's windowed stats at the solve (exact: a window multiplies
    every row weight of a month by the same 0/1); ``"off"`` keeps the
    per-spec contraction; ``"auto"`` factorizes where pairs repeat."""
    if factorize is None:
        factorize = (os.environ.get("FMRP_GRAM_FACTORIZE", "auto").strip().lower()
                     or "auto")
    if factorize not in GRAM_FACTORIZE_MODES:
        raise ValueError(f"gram factorize must be one of {GRAM_FACTORIZE_MODES}, "
                         f"got {factorize!r}")
    return factorize


def unique_pairs(uidx, col_sel, pad_to: Optional[int] = None):
    """Collapse the spec axis to its distinct (universe, col_sel) pairs,
    the factorized route's contraction axis (host numpy).

    Returns ``(uidx_u (K,), col_sel_u (K, P), pair_idx (S,))`` with
    ``uidx_u[pair_idx[s]] == uidx[s]`` and ``col_sel_u[pair_idx[s]] ==
    col_sel[s]``: specs differing only in their sample window share a pair.
    ``pad_to`` pads K by repeating pair 0 (rows no ``pair_idx`` points at)."""
    uidx = np.asarray(uidx)
    col_sel = np.asarray(col_sel, bool)
    seen: dict = {}
    pair_idx = np.empty(uidx.shape[0], np.int32)
    u_rows, c_rows = [], []
    for s in range(uidx.shape[0]):
        key = (int(uidx[s]), col_sel[s].tobytes())
        k = seen.get(key)
        if k is None:
            k = len(u_rows)
            seen[key] = k
            u_rows.append(int(uidx[s]))
            c_rows.append(col_sel[s])
        pair_idx[s] = k
    if pad_to is not None:
        if pad_to < len(u_rows):
            raise ValueError(f"pair pad {pad_to} is below the {len(u_rows)} distinct "
                             "(universe, col_sel) pairs this grid actually holds")
        while len(u_rows) < pad_to:
            u_rows.append(u_rows[0])
            c_rows.append(c_rows[0])
    return np.asarray(u_rows, uidx.dtype), np.stack(c_rows), pair_idx


class SpecGramStats(NamedTuple):
    """Per-spec, per-month normal-equation sufficient statistics over the
    augmented, per-month centered union design ``[1 | X_union − c]``
    (Q = P + 1). Slopes are shift-invariant; the raw intercept is recovered
    as ``a − Σ_p b_p·c[t,p]`` (``specgrid.solve``)."""

    gram: torch.Tensor    # (S, T, Q, Q)
    moment: torch.Tensor  # (S, T, Q)
    n: torch.Tensor       # (S, T) valid rows
    ysum: torch.Tensor    # (S, T) Σy over valid rows
    yy: torch.Tensor      # (S, T) Σy² over valid rows
    center: torch.Tensor  # (T, P) the per-month column shifts used


def auto_firm_chunk(t: int, n: int, q: int, itemsize: int,
                    budget_bytes: int = 128 * 2**20) -> int:
    """Chunk width so one (T, chunk, Q) weighted design stays under the
    byte budget, in multiples of 128 (minimum 128)."""
    per_firm = max(t * q * itemsize, 1)
    chunk = max(budget_bytes // per_firm, 128)
    chunk = min(chunk // 128 * 128, n)
    return max(chunk, min(n, 128))


def shared_center(x: torch.Tensor) -> torch.Tensor:
    """The per-month masked column means of the (T, N, P) union tensor —
    the default contraction center."""
    fin = torch.isfinite(x)
    total = torch.where(fin, x, torch.zeros_like(x)).sum(dim=1)
    return total / torch.clamp_min(fin.sum(dim=1), 1).to(x.dtype)


def split_stats(out: torch.Tensor, p: int):
    """The augmented (S, T, QE, QE) product of ``[1 | X − c | y]`` → gram,
    moment, n, Σy, Σy². The intercept-intercept entry is Σw (the row
    count)."""
    q = p + 1
    return (out[:, :, :q, :q], out[:, :, :q, q], out[:, :, 0, 0],
            out[:, :, 0, q], out[:, :, q, q])


def gram_spec_chunk(p: int, *, dtype: Optional[torch.dtype] = None) -> int:
    """The most specs one kernel launch takes at ``p`` predictor columns
    for operands of ``dtype`` (``None``: float32): up to 32 columns, for
    float32 and bfloat16, ⌊8192 / ((P+2)(P+3)/2)⌋, 60 at P = 14; past 32
    columns, and for float64 at any P, ``GRAM_ONE_LAUNCH_SPECS``, the whole
    batch of any real call."""
    if dtype == torch.float64 or p > 32:
        return GRAM_ONE_LAUNCH_SPECS
    return GRAM_MAX_ENTRIES // ((p + 2) * (p + 3) // 2)


def selection_words(col_sel: torch.Tensor) -> torch.Tensor:
    """The (S, P) bool column selector as the kernel's (S, W) int32 words,
    W = max(1, ⌈P/32⌉): bit ``c % 32`` of word ``c // 32`` is set when the
    spec selects column ``c``."""
    s, p = col_sel.shape
    words = max(1, -(-p // 32))
    bits = torch.zeros((s, words * 32), dtype=torch.int64, device=col_sel.device)
    bits[:, :p] = col_sel.to(torch.int64)
    weights = 2 ** torch.arange(32, device=col_sel.device, dtype=torch.int64)
    packed = (bits.reshape(s, words, 32) * weights).sum(-1)
    # the same 32 bits as a signed word
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32).contiguous()


def _up16(b: int) -> int:
    return (b + 15) & ~15


def _strip_chunk(qe: int) -> int:
    """``make_strips(qe).cs`` of ``csrc/gram.cu``: the tiles a task sums."""
    mt, nt = -(-qe // 16), -(-qe // 8)
    h = nt - mt + 1
    k = -(-h // 8)
    return -(-h // k)


def _smallest_block_bytes(p: int, dtype: torch.dtype, specs: int, weighted: bool) -> int:
    """The shared memory of the smallest block the wide kernel of ``dtype``
    can run at ``p`` columns: a 16-firm tile and one task (the layouts
    ``make_dmma_layout``, ``make_wide_layout`` and ``make_f32_wide_layout``
    of ``csrc/gram.cu``; one spec a block, or for float32 the two a task of
    32 tiles can touch)."""
    tile, isz = 16, {torch.float64: 8, torch.float32: 4, torch.bfloat16: 2}[dtype]
    qe, nwb = p + 2, p // 32 + 1
    if dtype == torch.float32:
        nseg = -(-qe // 8)
        ntile = nseg * (nseg + 1) // 2
        nsb = min((32 + ntile - 2) // ntile + 1, specs)
    else:
        nsb = 1
    row = _up16(tile * isz + 16)
    stage = _up16(tile * p * isz + 16) + row * (2 if weighted else 1) + _up16(tile + 16) * nsb
    total = 2 * stage + 16 + _up16(p * (4 if dtype == torch.bfloat16 else isz))
    total += _up16(nsb * nwb * 4) + _up16(nsb * 4) + _up16(tile * nwb * 4)
    if dtype == torch.float64:
        built = tile * (16 * -(-qe // 16) + 4) * 8 + _up16(nsb * tile * 8)
        return total + 2 * built + _up16(8 * 4) + _strip_chunk(qe) * 128 * 8
    if dtype == torch.bfloat16:
        rows = 16 * -(-qe // 16) * (tile * 2 + 16)
        built = rows * (3 if weighted else 1) + _up16(nsb * tile * 2)
        return total + 2 * built + _up16(8 * 4) + _strip_chunk(qe) * 128 * 4
    nseg = -(-qe // 8)
    built = tile * 8 * nseg * 4 + _up16(nsb * (tile + 1) * 4)
    return total + 2 * built + _up16(32 * 4) + 64 * 32 * 4


def gram_launch_fits(p: int, dtype: Optional[torch.dtype] = None, specs: int = 1,
                     weighted: bool = False) -> bool:
    """Whether one launch of the Gram kernel takes a union of ``p`` columns
    for ``specs`` specs of operands ``dtype`` (``None``: float32), with or
    without row weights: always on the tile route (``gram_tile_plan``) and
    up to 32 columns; else whether the wide kernel's smallest block, a
    16-firm tile, fits in the 227 KB of shared memory a block may have
    (the one-launch kernels' reach: 848 float32 columns at two specs or
    more, 850 at one, 847 with row weights; 424 float64 columns, 423 with
    row weights; 1,367 with bfloat16 operands, 622 with row weights).
    Below ``GRAM_TILE_FROM`` every union is within that reach, so every
    call is one launch."""
    dtype = torch.float32 if dtype is None else dtype
    if p <= 32 or gram_tile_plan(p, dtype, specs) is not None:
        return True
    return _smallest_block_bytes(p, dtype, specs, weighted) <= _SMEM_MAX


class GramTilePlan(NamedTuple):
    """The tile-pair kernel's walk of a union past ``GRAM_TILE_FROM``.

    The augmented columns ``[1 | x − c | y]`` (QE = P + 2; column 0 the
    intercept, column P + 1 y) are cut into ``tiles`` tiles of ``cols``
    columns, tile I holding columns I·cols .. (I + 1)·cols − 1 (the last
    padded past QE). A block sums one pair (I, J), I ≤ J, for one month and
    one group of ``spec_group`` consecutive specs (the last maybe fewer) and
    writes the (I, J) rectangle of each spec's block and its mirror, a
    diagonal pair (I = J) its entries on or above the diagonal and their
    mirrors: every entry of the block has one writer. The blocks of a month
    take ``pairs`` in order, the groups of a pair together."""

    p: int
    cols: int                 # augmented columns a tile
    tiles: int                # ⌈(P + 2) / cols⌉
    pairs: tuple              # ((I, J), ...), I ≤ J, row by row
    spec_group: int           # specs a block sums
    groups: int               # blocks a (pair, month): ⌈S / spec_group⌉


def gram_tile_plan(p: int, dtype: Optional[torch.dtype] = None,
                   specs: int = 1) -> Optional[GramTilePlan]:
    """The tile-pair kernel's plan for a ``p``-column union of ``specs``
    specs of operands ``dtype`` (``None``: float32), or None below
    ``GRAM_TILE_FROM[dtype]``, where the call takes a one-launch kernel.
    With or without row weights the plan is the same. The specs are dealt
    into the fewest groups of at most ``GRAM_TILE_SPECS``, near equal."""
    dtype = torch.float32 if dtype is None else dtype
    if p < GRAM_TILE_FROM[dtype]:
        return None
    tiles = -(-(p + 2) // GRAM_TILE_COLS)
    pairs = tuple((i, j) for i in range(tiles) for j in range(i, tiles))
    groups = -(-specs // GRAM_TILE_SPECS)
    return GramTilePlan(p, GRAM_TILE_COLS, tiles, pairs, -(-specs // groups), groups)


def gram_launch_count(p: int, specs: int, dtype: Optional[torch.dtype] = None) -> int:
    """The Gram kernel launches one ``gram_contract_cuda`` call makes at
    ``p`` columns and ``specs`` specs of operands ``dtype`` (``None``:
    float32), with or without row weights: one on the tile route
    (``gram_tile_plan``), else one a chunk of ``gram_spec_chunk`` specs.
    The pre-pass (``gram_fold_cuda``: once a call on the tile route) counts
    apart."""
    dtype = torch.float32 if dtype is None else dtype
    if gram_tile_plan(p, dtype, specs) is not None:
        return 1
    return -(-specs // gram_spec_chunk(p, dtype=dtype))


def gram_fold_plain(y: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                    col_sel: torch.Tensor) -> torch.Tensor:
    """The plain version of the pre-pass: (S, T, N) uint8, ``valid`` and
    finite(y) and no column the spec selects non-finite in x."""
    bad = torch.einsum("tnp,sp->stn", (~torch.isfinite(x)).to(torch.float32),
                       col_sel.to(torch.float32))
    return ((valid != 0) & torch.isfinite(y)[None] & (bad == 0)).to(torch.uint8)


def gram_fold_cuda(y: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                   col_sel: torch.Tensor) -> torch.Tensor:
    """Launch the pre-pass kernel (``csrc/gram.cu::gram_fold``) on CUDA
    tensors as ``gram_contract_cuda`` takes them: the (S, T, N) uint8 valid
    mask with finite(y) and the finiteness of each spec's selected columns
    folded in, which the tile-pair kernel reads (each of its blocks sees
    only two tiles' columns)."""
    t, n, p = x.shape
    s = col_sel.shape[0]
    out = torch.empty((s, t, n), dtype=torch.uint8, device=x.device)
    if t == 0 or n == 0 or s == 0:
        return out
    sel_bits = selection_words(col_sel)
    fn = kernel_function("gram", "gram_fold", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(_DTYPE_CODES[x.dtype][0], x.data_ptr(), y.data_ptr(), valid.data_ptr(),
                    sel_bits.data_ptr(), out.data_ptr(), t, n, p, s, stream)
        check_status("gram", status)
        gram_fold_cuda.launches += 1
        key = f"P={p},S={s},{_DTYPE_CODES[x.dtype][1]}"
        gram_fold_cuda.launches_by_key[key] = gram_fold_cuda.launches_by_key.get(key, 0) + 1
    return out


# launch counters of the pre-pass: the total, and per call shape
# "P=<columns>,S=<specs>,<f32|f64|bf16>"
gram_fold_cuda.launches = 0
gram_fold_cuda.launches_by_key = {}


def gram_contract_plain(y: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                        col_sel: torch.Tensor, center: torch.Tensor,
                        row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``gram_contract_cuda``, on any device: the
    augmented (S, T, P+2, P+2) blocks from ``contract_spec_grams_plain``
    (float32 for bfloat16 operands)."""
    t, _, p = x.shape
    q = p + 1
    gram, moment, _, _, yy = contract_spec_grams_plain(
        y, x, valid != 0, col_sel, None, center, row_weights=row_weights)
    out = torch.zeros((col_sel.shape[0], t, q + 1, q + 1), dtype=gram.dtype, device=x.device)
    out[:, :, :q, :q] = gram
    out[:, :, :q, q] = moment
    out[:, :, q, :q] = moment
    out[:, :, q, q] = yy
    return out


def gram_contract_cuda(y: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                       col_sel: torch.Tensor, center: torch.Tensor,
                       row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Gram kernel. y (T, N), x (T, N, P), center (T, P) and
    the optional row weights (T, N) are contiguous CUDA tensors of one
    dtype: float32, float64, or bfloat16 (summed in float32); valid (S, T,
    N) uint8 (universe ∧ window); col_sel (S, P) bool. Returns the
    augmented (S, T, P+2, P+2) blocks, float32 for bfloat16 operands and
    x's dtype otherwise.

    A spec batch over what one launch takes is cut into consecutive
    chunks of ``gram_spec_chunk(P, dtype=x.dtype)`` specs, one launch each,
    each writing its own slice of the output; the cut depends only on (S,
    P, dtype): float32 and bfloat16 up to 32 columns at 8192 block entries,
    float64, and every dtype past 32 columns, in one launch. The spec's
    columns go to the kernel as ⌈P/32⌉ words of bits (``selection_words``).
    Any P: from ``GRAM_TILE_FROM[x.dtype]`` columns the call takes the
    pre-pass and one launch of the tile-pair kernel (``gram_tile_plan``),
    with or without row weights. Raises on anything the kernel does not
    take."""
    tensors = {"y": y, "x": x, "valid": valid, "col_sel": col_sel,
               "center": center}
    if row_weights is not None:
        tensors["row_weights"] = row_weights
    for name, a in tensors.items():
        if not a.is_cuda or a.device != x.device:
            raise ValueError(f"gram kernel: {name} must be on {x.device} (CUDA)")
        if not a.is_contiguous():
            raise ValueError(f"gram kernel: {name} must be contiguous")
    if x.dtype not in _DTYPE_CODES or any(
            a.dtype != x.dtype for a in (y, center, row_weights) if a is not None):
        raise TypeError("gram kernel takes float32, float64 or bfloat16 x, y, center "
                        "and row weights of one dtype")
    if valid.dtype != torch.uint8 or col_sel.dtype != torch.bool:
        raise TypeError("gram kernel takes a uint8 valid mask and a bool col_sel")
    t, n, p = x.shape
    s = col_sel.shape[0]
    if (y.shape != (t, n) or valid.shape != (s, t, n)
            or col_sel.shape != (s, p) or center.shape != (t, p)
            or (row_weights is not None and row_weights.shape != (t, n))):
        raise ValueError("gram kernel: inconsistent shapes")
    out_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    out = torch.zeros((s, t, p + 2, p + 2), dtype=out_dtype, device=x.device)
    if t == 0 or n == 0 or s == 0:
        return out
    key = f"P={p},S={s},{_DTYPE_CODES[x.dtype][1]}" + (",rw" if row_weights is not None else "")
    tiles = gram_tile_plan(p, x.dtype, s)
    if tiles is not None:
        return _launch_tiles(y, x, valid, col_sel, center, row_weights, out, tiles, key)
    return _launch_contract(y, x, valid, col_sel, center, row_weights, out, key)


def _launch_contract(y, x, valid, col_sel, center, row_weights, out, key: str):
    """One launch of the kernel a chunk of ``gram_spec_chunk`` specs,
    into ``out``; each counted under ``key``."""
    t, n, p = x.shape
    s = col_sel.shape[0]
    sel_bits = selection_words(col_sel)
    fn = kernel_function("gram", "gram_contract", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    rw_ptr = row_weights.data_ptr() if row_weights is not None else None
    chunk = gram_spec_chunk(p, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s0 in range(0, s, chunk):
            s1 = min(s0 + chunk, s)
            status = fn(_DTYPE_CODES[x.dtype][0], x.data_ptr(), y.data_ptr(), rw_ptr,
                        valid[s0:s1].data_ptr(), sel_bits[s0:s1].data_ptr(),
                        center.data_ptr(), out[s0:s1].data_ptr(), t, n, p,
                        s1 - s0, stream)
            check_status("gram", status)
            gram_contract_cuda.launches += 1
            by_key = gram_contract_cuda.launches_by_key
            by_key[key] = by_key.get(key, 0) + 1
    return out


def _launch_tiles(y, x, valid, col_sel, center, row_weights, out, plan: GramTilePlan,
                  key: str):
    """The tile route into ``out``: the pre-pass, then one launch of the
    tile-pair kernel over ``plan`` (its pairs as an int32 array on the
    device), counted under ``key``."""
    t, n, p = x.shape
    s = col_sel.shape[0]
    folded = gram_fold_cuda(y, x, valid, col_sel)
    pairs = torch.tensor(plan.pairs, dtype=torch.int32).to(x.device)
    fn = kernel_function("gram", "gram_tiles", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])
    rw_ptr = row_weights.data_ptr() if row_weights is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(_DTYPE_CODES[x.dtype][0], x.data_ptr(), y.data_ptr(), rw_ptr,
                    folded.data_ptr(), center.data_ptr(), out.data_ptr(), t, n, p, s,
                    pairs.data_ptr(), len(plan.pairs), plan.cols, plan.spec_group, stream)
        check_status("gram", status)
        gram_contract_cuda.launches += 1
        by_key = gram_contract_cuda.launches_by_key
        by_key[key] = by_key.get(key, 0) + 1
    return out


# launch counters: the total, and per call shape
# "P=<columns>,S=<specs>,<f32|f64|bf16>[,rw]" (a call cut into chunks adds
# one per launch)
gram_contract_cuda.launches = 0
gram_contract_cuda.launches_by_key = {}


def contract_spec_grams_plain(y, x, uni, col_sel, window, center,
                              firm_chunk: Optional[int] = None,
                              row_weights: Optional[torch.Tensor] = None):
    """The plain PyTorch version of the Gram kernel, on any device: a
    chunked masked einsum over firm slices, one weighted design per spec.
    ``uni`` is the (S, T, N) bool universe mask of each spec, ``window``
    (S, T) bool or None (no window term). bfloat16 operands (x, y, center,
    row weights) form ``x − c`` in bfloat16 and everything after it in
    float32, whose stats they return."""
    t, n_firms, p = x.shape
    q = p + 1
    low = x.dtype == torch.bfloat16
    dtype = torch.float32 if low else x.dtype
    s_specs = col_sel.shape[0]
    # the budget is the float32/float64 weighted design's, whatever the operands
    chunk = firm_chunk or auto_firm_chunk(t, n_firms, q, torch.finfo(dtype).bits // 8)
    sel_f = col_sel.to(dtype)
    zeros = dict(dtype=dtype, device=x.device)
    gram = torch.zeros((s_specs, t, q, q), **zeros)
    moment = torch.zeros((s_specs, t, q), **zeros)
    n_acc = torch.zeros((s_specs, t), **zeros)
    ysum = torch.zeros((s_specs, t), **zeros)
    yy = torch.zeros((s_specs, t), **zeros)
    for start in range(0, n_firms, chunk):
        sl = slice(start, min(start + chunk, n_firms))
        xc, yc = x[:, sl], y[:, sl]
        finx = torch.isfinite(xc)
        finy = torch.isfinite(yc)
        # x − c in the operand dtype (rounded there for bfloat16), then up
        xz = torch.where(finx, xc - center[:, None, :], torch.zeros_like(xc)).to(dtype)
        yz = torch.where(finy, yc, torch.zeros_like(yc)).to(dtype)
        bad = torch.einsum("tnp,sp->stn", (~finx).to(dtype), sel_f)
        valid = uni[:, :, sl] & finy[None] & (bad == 0)
        if window is not None:
            valid = valid & window[:, :, None]
        xa = torch.cat([torch.ones_like(yz)[..., None], xz], dim=-1)
        rw = row_weights[:, sl].to(dtype) if row_weights is not None else None
        for s in range(s_specs):
            w = valid[s].to(dtype)
            if rw is not None:
                w = w * rw
            b = xa * w[..., None]
            gram[s] += torch.einsum("tnp,tnq->tpq", b, xa)
            moment[s] += torch.einsum("tnp,tn->tp", b, yz)
            wy = w * yz
            n_acc[s] += w.sum(-1)
            ysum[s] += wy.sum(-1)
            yy[s] += (wy * yz).sum(-1)
    return gram, moment, n_acc, ysum, yy


def contract_spec_grams(
    y: torch.Tensor,
    x: torch.Tensor,
    universes: torch.Tensor,
    uidx: torch.Tensor,
    col_sel: torch.Tensor,
    window: Optional[torch.Tensor],
    firm_chunk: Optional[int] = None,
    center: Optional[torch.Tensor] = None,
    row_weights: Optional[torch.Tensor] = None,
    precision: str = "highest",
    expect_shared_center: bool = False,
) -> SpecGramStats:
    """Contract the (T, N, P) union panel into (S, T, Q, Q) Gram stats.

    y (T, N) regressand; x (T, N, P) union predictor columns; universes
    (U, T, N) bool; uidx (S,) each spec's universe row; col_sel (S, P)
    bool; window (S, T) bool, or None for no window term (the factorized
    route). ``center`` (T, P) defaults to ``shared_center(x)``;
    ``row_weights`` (T, N) multiply each spec's 0/1 validity; ``precision``
    is ``"highest"`` or ``"bf16"`` (module docstring: the stats are then
    float32 and ``center`` is the bfloat16 center upcast). ``firm_chunk``
    sets the plain version's firm slice width. CUDA tensors run the Gram
    kernel, CPU tensors the plain version; validity per spec = universe ∧
    finite(y) ∧ finite(selected x) ∧ window either way.
    ``expect_shared_center`` declares the call one shard of a sharded
    merge: it raises when ``center`` is None, where a shard-local mean
    would break the additivity the merge relies on.
    """
    if precision not in GRAM_PRECISIONS:
        raise ValueError(f"precision must be one of {GRAM_PRECISIONS}, got {precision!r}")
    if expect_shared_center and center is None:
        raise ValueError(
            "this contraction is one shard of a sharded merge: the caller must pass the "
            "one globally agreed center (grams.shared_center over the full panel, merged "
            "across shards); a shard-local masked mean would break the Gram additivity "
            "the merge relies on")
    dtype = x.dtype
    center = shared_center(x) if center is None else center.to(dtype)
    y = y.to(dtype)
    if row_weights is not None:
        row_weights = row_weights.to(dtype)
    if precision == "bf16":
        # operands rounded to bfloat16 once; the center returned is the one
        # the contraction subtracted
        x, y, center = (a.to(torch.bfloat16) for a in (x, y, center))
        if row_weights is not None:
            row_weights = row_weights.to(torch.bfloat16)
    out_center = center.to(torch.float32) if precision == "bf16" else center
    uni = universes[uidx]                       # (S, T, N)
    if x.is_cuda:
        valid = uni if window is None else uni & window[:, :, None]
        out = gram_contract_cuda(
            y.contiguous(), x.contiguous(), valid.to(torch.uint8).contiguous(),
            col_sel.contiguous(), center.contiguous(),
            None if row_weights is None else row_weights.contiguous())
        gram, moment, n, ysum, yy = split_stats(out, x.shape[-1])
    else:
        gram, moment, n, ysum, yy = contract_spec_grams_plain(
            y, x, uni, col_sel, window, center, firm_chunk=firm_chunk,
            row_weights=row_weights,
        )
    return SpecGramStats(gram, moment, n, ysum, yy, out_center)
