"""Masked contraction of the dense panel into per-spec Gram statistics.

Per-month OLS sufficient statistics are ADDITIVE over firms, so every spec
cell is a weighted contraction of the SAME augmented design

    G_s[t] = Σ_n  w_s[t,n] · x̃[t,n,:] x̃[t,n,:]ᵀ ,  x̃ = [1 | X_union − c_t]

where ``w_s`` is the spec's 0/1 row validity (universe mask ∧ finite y ∧
finite selected predictors ∧ sample window) and ``c_t`` a per-month column
shift that decollinearizes the intercept column. Non-finite entries of
UNSELECTED columns enter as zero, so each spec's selected block is exact
and the rest is ignored by the padded solve (``specgrid.solve``).

``contract_spec_grams`` takes one of two versions, chosen by where the
tensors lie:

- CUDA tensors go to the hand-written kernel (``csrc/gram.cu``, wrapper
  ``gram_contract_cuda``): one block per month reads the panel once for all
  specs and builds the weights in shared memory;
- CPU tensors take the plain version, a chunked masked einsum over firm
  slices (``contract_spec_grams_plain``).

There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fm_returnprediction_tpu_torch.cuda_build import check_status, kernel_function

__all__ = [
    "SpecGramStats",
    "auto_firm_chunk",
    "shared_center",
    "contract_spec_grams",
    "contract_spec_grams_plain",
    "gram_contract_cuda",
    "split_stats",
]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


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


def gram_contract_cuda(y: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                       col_sel: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Launch the Gram kernel. y (T, N), x (T, N, P), center (T, P) float32
    or float64 contiguous CUDA tensors of one dtype; valid (S, T, N) uint8
    (universe ∧ window); col_sel (S, P) bool. Returns the augmented
    (S, T, P+2, P+2) blocks in x's dtype. Raises on anything the kernel
    does not take."""
    tensors = {"y": y, "x": x, "valid": valid, "col_sel": col_sel,
               "center": center}
    for name, a in tensors.items():
        if not a.is_cuda or a.device != x.device:
            raise ValueError(f"gram kernel: {name} must be on {x.device} (CUDA)")
        if not a.is_contiguous():
            raise ValueError(f"gram kernel: {name} must be contiguous")
    if x.dtype not in _DTYPE_CODES or y.dtype != x.dtype or center.dtype != x.dtype:
        raise TypeError("gram kernel takes float32/float64 x, y, center of one dtype")
    if valid.dtype != torch.uint8 or col_sel.dtype != torch.bool:
        raise TypeError("gram kernel takes a uint8 valid mask and a bool col_sel")
    t, n, p = x.shape
    s = col_sel.shape[0]
    if (y.shape != (t, n) or valid.shape != (s, t, n)
            or col_sel.shape != (s, p) or center.shape != (t, p)):
        raise ValueError("gram kernel: inconsistent shapes")
    if p > 32:
        raise ValueError(f"gram kernel takes at most 32 predictor columns, got {p}")
    out = torch.zeros((s, t, p + 2, p + 2), dtype=x.dtype, device=x.device)
    if t == 0 or n == 0 or s == 0:
        return out
    weights = 2 ** torch.arange(p, device=x.device, dtype=torch.int64)
    sel_bits = (col_sel.to(torch.int64) * weights).sum(-1).to(torch.int32)
    fn = kernel_function("gram", "gram_contract", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(x.device):
        status = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
                    valid.data_ptr(), sel_bits.data_ptr(), center.data_ptr(),
                    out.data_ptr(), t, n, p, s,
                    torch.cuda.current_stream().cuda_stream)
    check_status("gram", status)
    gram_contract_cuda.launches += 1
    key = f"P={p},S={s}"
    by_key = gram_contract_cuda.launches_by_key
    by_key[key] = by_key.get(key, 0) + 1
    return out


# launch counters: the total, and per "P=<columns>,S=<specs>"
gram_contract_cuda.launches = 0
gram_contract_cuda.launches_by_key = {}


def contract_spec_grams_plain(y, x, uni, col_sel, window, center,
                              firm_chunk: Optional[int] = None):
    """The plain PyTorch version of the Gram kernel, on any device: a
    chunked masked einsum over firm slices, one weighted design per spec.
    ``uni`` is the (S, T, N) bool universe mask of each spec."""
    t, n_firms, p = x.shape
    q = p + 1
    dtype = x.dtype
    s_specs = col_sel.shape[0]
    chunk = firm_chunk or auto_firm_chunk(t, n_firms, q, x.element_size())
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
        xz = torch.where(finx, xc - center[:, None, :], torch.zeros_like(xc))
        yz = torch.where(finy, yc, torch.zeros_like(yc))
        bad = torch.einsum("tnp,sp->stn", (~finx).to(dtype), sel_f)
        valid = uni[:, :, sl] & finy[None] & (bad == 0) & window[:, :, None]
        xa = torch.cat([torch.ones_like(yc)[..., None], xz], dim=-1)
        for s in range(s_specs):
            w = valid[s].to(dtype)
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
    window: torch.Tensor,
    firm_chunk: Optional[int] = None,
    center: Optional[torch.Tensor] = None,
) -> SpecGramStats:
    """Contract the (T, N, P) union panel into (S, T, Q, Q) Gram stats.

    y (T, N) regressand; x (T, N, P) union predictor columns; universes
    (U, T, N) bool; uidx (S,) each spec's universe row; col_sel (S, P)
    bool; window (S, T) bool. ``center`` (T, P) defaults to
    ``shared_center(x)``. ``firm_chunk`` sets the plain version's firm
    slice width. CUDA tensors run the Gram kernel, CPU tensors the plain
    version; validity per spec = universe ∧ finite(y) ∧ finite(selected
    x) ∧ window either way.
    """
    dtype = x.dtype
    center = shared_center(x) if center is None else center.to(dtype)
    uni = universes[uidx]                       # (S, T, N)
    if x.is_cuda:
        valid = (uni & window[:, :, None]).to(torch.uint8)
        out = gram_contract_cuda(y.to(dtype).contiguous(), x.contiguous(),
                                 valid.contiguous(), col_sel.contiguous(),
                                 center.contiguous())
        gram, moment, n, ysum, yy = split_stats(out, x.shape[-1])
    else:
        gram, moment, n, ysum, yy = contract_spec_grams_plain(
            y, x, uni, col_sel, window, center, firm_chunk=firm_chunk,
        )
    return SpecGramStats(gram, moment, n, ysum, yy, center)
