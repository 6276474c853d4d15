#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py            # full run: build, kernel phases, main
                                     # path at real size, card-vs-CPU check
    python3 chip_smoke.py --kernels-only --ptxas   # build + one checked
                                     # launch per kernel, no timing

Phases (any failure exits non-zero without the final line):

1. the card's name and power limit (``nvidia-smi``), torch/CUDA versions,
   and ``torch.backends.cuda.matmul.allow_tf32`` (must be False);
2. build every kernel from ``fm_returnprediction_tpu_torch/csrc``;
3. each kernel against its plain version at the main path's shapes, float32
   and float64, with the tolerance printed beside the error, then CUDA-event
   timings of kernel, plain version and (where one exists) a library call;
4. the main path at real size — 600 months, 22,000 firms, ~77M daily rows
   built from ``--seed`` by ``data.smoke_inputs`` — through
   ``run_pipeline(device="cuda", dtype=torch.float32)`` and all of its
   stages (characteristics, universes, Table 1, Table 2, the figure/decile
   sweep, Figure 1's rolling slopes, the decile table, the serving state),
   with every kernel launch counter set to 0 just before and read just
   after;
5. K1 std at every daily-strip shape the main path launched it at (read
   from its counters), checked and timed, with the sum of launches × time;
6. the same path at a mid size in float64 on the card and on the CPU (plain
   versions): Table 2's per-cell numbers (a coefficient at
   ``|d| <= 1e-8 * max(|b|, nw_se)``, its t-stat at ``1e-8 * max(|t|, 1)``,
   the rest at rtol 1e-8), Table 1, the decile table, the figure frames and
   the serving state.

The masked cumulative moments kernel has no caller on the main path (nor
in the JAX package it mirrors); its row carries ``"launches": 0`` and says
so, and phase 3 holds it against its plain version like every other, also
on a ragged multi-chunk shape, checks that two launches give the same bits,
and prints each shape's chunk plan.

The last lines are a JSON object of per-kernel numbers, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from fm_returnprediction_tpu_torch.cuda_build import build_kernels
from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs
from fm_returnprediction_tpu_torch.ops.rolling import (
    masked_cumulative_moments_cuda,
    masked_cumulative_moments_plain,
    moments_chunk_plan,
    moments_chunk_rows,
    rolling_reduce_cuda,
    rolling_reduce_plain,
)
from fm_returnprediction_tpu_torch.pipeline import run_pipeline
from fm_returnprediction_tpu_torch.specgrid.grams import (
    contract_spec_grams_plain,
    gram_contract_cuda,
    shared_center,
    split_stats,
)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM FP32 outside the tensor cores
FP64_FLOPS = 34e12            # H100 SXM FP64 outside the tensor cores

K1_SOURCE = "fm_returnprediction_tpu_torch/csrc/rolling.cu"
K1_REPLACES = "fm_returnprediction_tpu/ops/pallas_kernels.py:216"
K2_SOURCE = "fm_returnprediction_tpu_torch/csrc/gram.cu"
K2_REPLACES = "fm_returnprediction_tpu/ops/gram_pallas.py:120"
K3_SOURCE = "fm_returnprediction_tpu_torch/csrc/rolling.cu"
K3_REPLACES = "fm_returnprediction_tpu/ops/pallas_kernels.py:132"
K3_MAIN_PATH = "no caller in the JAX package"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def worst_of(a: torch.Tensor) -> float:
    """The largest entry, a NaN counting as infinitely large (Python's
    ``max`` would pass over it)."""
    return float(torch.nan_to_num(a, nan=float("inf")).max())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    peak = FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- K1: the rolling family ----------------------------------------------


def rolling_input(t: int, n: int, dtype, gen, scale: float, nan_frac: float):
    """A compacted-layout (T, N) input: each column's rows packed to the
    front (random lengths), NaN tail, scattered NaNs."""
    x = torch.randn((t, n), generator=gen, device="cuda", dtype=dtype) * scale
    counts = torch.randint(0, t + 1, (n,), generator=gen, device="cuda")
    tail = torch.arange(t, device="cuda")[:, None] >= counts[None, :]
    holes = torch.rand((t, n), generator=gen, device="cuda") < nan_frac
    return torch.where(tail | holes, torch.full_like(x, float("nan")), x)


def rolling_tolerance(x, kind: str, window: int, rel: float):
    """Per-element tolerance ``rel·|p| + atol``: both sides subtract two
    cumulative sums, so the absolute part scales with eps times the
    column's largest cumulative magnitude (C1 = Σ|x|, C2 = Σx²)."""
    eps = torch.finfo(x.dtype).eps
    fin = torch.isfinite(x)
    xz = torch.where(fin, x, torch.zeros_like(x))
    c1 = xz.abs().sum(0)[None, :]
    c2 = (xz * xz).sum(0)[None, :]
    cnt = rolling_reduce_plain(fin.to(x.dtype), window, 0, "sum")
    if kind == "sum":
        atol = 4 * eps * c1
    elif kind == "mean":
        atol = 4 * eps * c1 / torch.clamp_min(cnt, 1)
    else:
        w1 = rolling_reduce_plain(x, window, 0, "sum").abs()
        var_err = 4 * eps * (c2 + 2 * w1 * c1 / torch.clamp_min(cnt, 1))
        atol = torch.sqrt(var_err / torch.clamp_min(cnt - 1, 1))
    return atol, rel


def check_rolling(x, window: int, min_periods: int, kind: str, rel: float,
                  label: str) -> float:
    got = rolling_reduce_cuda(x, window, min_periods, kind)
    want = rolling_reduce_plain(x, window, min_periods, kind)
    torch.cuda.synchronize()
    atol, rel = rolling_tolerance(x, kind, window, rel)
    same_nan = bool((torch.isnan(got) == torch.isnan(want)).all())
    fin = torch.isfinite(want)
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(want))
    limit = (rel * want.abs() + atol).clamp_min(torch.finfo(x.dtype).tiny)
    ratio = float(torch.where(fin, diff / limit, torch.zeros_like(diff)).max())
    max_abs = float(diff.max())
    max_rel = float(torch.where(fin, diff / want.abs().clamp_min(torch.finfo(x.dtype).tiny),
                                torch.zeros_like(diff)).max())
    log(f"K1 {label}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
        f"tol=|d|<={rel:g}*|p|+{{4eps*C}} worst_ratio={ratio:.3f} "
        f"nan_pattern_equal={same_nan}")
    check(same_nan, f"K1 {label}: NaN pattern differs from the plain version")
    check(ratio <= 1.0, f"K1 {label}: error beyond tolerance")
    return max_abs


def k1_row(x, window: int, mp: int, kind: str, err: float, label: str) -> dict:
    """Time the rolling kernel and its plain version on ``x``; the kernel
    table row (launches filled in from the main path's counters)."""
    t, n = x.shape
    ms = time_ms(lambda: rolling_reduce_cuda(x, window, mp, kind))
    plain_ms = time_ms(lambda: rolling_reduce_plain(x, window, mp, kind))
    b_ms, b_by = bound(2 * x.numel() * x.element_size(), 12 * x.numel(), x.dtype)
    log(f"K1 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name=f"rolling_reduce[{kind},w={window}] {t}x{n} f32",
                key=f"{kind}/w={window},{t}x{n}", route="cuda", source=K1_SOURCE,
                replaces=K1_REPLACES, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def k1_phase(gen, timed: bool):
    cases = [  # (label, T, N, kind, window, min_periods, scale, nan_frac, timed)
        ("sum w=12 mp=1 (dy)", 600, 22000, "sum", 12, 1, 1.0, 0.02, True),
        ("sum w=24 mp=24 (log_return_13_36)", 600, 22000, "sum", 24, 24, 0.1, 0.02, True),
        ("mean w=12 mp=12 (turnover)", 600, 22000, "mean", 12, 12, 1.0, 0.02, False),
        # the daily strips are timed one by one after the main path, at the
        # shapes its counters show (strip_phase)
        ("std w=252 mp=100 (daily vol)", 13312, 2432, "std", 252, 100, 0.02, 0.005, False),
        # several chunks with window = chunk/2: every warm-up reaches back a
        # whole window into the chunk before
        ("std w=300 mp=2 (warm-up of a whole window)", 3000, 2432, "std", 300, 2, 0.02, 0.005,
         False),
        ("mean w=300 mp=2 (warm-up of a whole window)", 3000, 2432, "mean", 300, 2, 0.02, 0.005,
         False),
        # Figure 1's slope means of 3 subsets × 5 variables in one call, and
        # one subset's lagged [intercept, 5 slopes] forecast means
        ("mean w=120 mp=60 (figure slopes)", 600, 15, "mean", 120, 60, 0.01, 0.1, True),
        ("mean w=120 mp=60 (forecast coefs)", 600, 6, "mean", 120, 60, 0.01, 0.1, True),
    ]
    rows = []
    for label, t, n, kind, window, mp, scale, nan_frac, on_path in cases:
        for dtype, rel in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            x = rolling_input(t, n, dtype, gen, scale, nan_frac)
            tag = f"{label} {t}x{n} {str(dtype)[6:]}"
            err = check_rolling(x, window, mp, kind, rel, tag)
            if dtype == torch.float32 and timed and on_path:
                rows.append(k1_row(x, window, mp, kind, err, tag))
            del x
    torch.cuda.empty_cache()
    return rows


STRIP_KEY = re.compile(r"^std/w=(\d+),(\d+)x(\d+)$")


def strip_phase(gen, by_shape: dict, mp: int = 100):
    """K1 std at every daily-strip shape the main path launched it at (read
    from its counters, so another seed's strip heights cannot break the
    launch check): checked against the plain version, timed, and summed as
    launches × time over the main path."""
    strips = []
    for key, count in by_shape.items():
        match = STRIP_KEY.match(key)
        if match:
            window, t, n = (int(v) for v in match.groups())
            strips.append((t, n, window, count))
    rows, total_ms, launches = [], 0.0, 0
    for t, n, window, count in sorted(strips, reverse=True):
        x = rolling_input(t, n, torch.float32, gen, 0.02, 0.005)
        label = f"std w={window} mp={mp} (daily strip) {t}x{n} float32"
        err = check_rolling(x, window, mp, "std", 1e-4, label)
        row = k1_row(x, window, mp, "std", err, label)
        total_ms += count * row["ms"]
        launches += count
        rows.append(row)
        del x
    torch.cuda.empty_cache()
    log(f"K1 std on the main path's daily strips: {launches} launches, "
        f"sum of launches × kernel time {total_ms:.4f} ms")
    return rows


# --- K2: the Gram contraction ----------------------------------------------


def gram_inputs(t: int, n: int, p: int, dtype, gen, figure: bool = False):
    """The contraction inputs: x (T, N, P) with NaNs and an all-NaN firm
    column, y with NaNs, 3 universes, valid = universe of each spec. Table
    2's grid has 9 specs (3 nested models × 3 universes); the figure grid
    (``figure=True``) 3, every column in each."""
    x = torch.randn((t, n, p), generator=gen, device="cuda", dtype=dtype)
    x = torch.where(torch.rand((t, n, p), generator=gen, device="cuda") < 0.05,
                    torch.full_like(x, float("nan")), x)
    x[:, 7, 2] = float("nan")
    y = 0.1 * torch.randn((t, n), generator=gen, device="cuda", dtype=dtype)
    y = torch.where(torch.rand((t, n), generator=gen, device="cuda") < 0.1,
                    torch.full_like(y, float("nan")), y)
    universes = torch.rand((3, t, n), generator=gen, device="cuda") > \
        torch.tensor([0.1, 0.4, 0.7], device="cuda")[:, None, None]
    if figure:
        col_sel = torch.ones((3, p), dtype=torch.bool, device="cuda")
    else:
        col_sel = torch.zeros((9, p), dtype=torch.bool, device="cuda")
        for mi, k in enumerate([3, 7, p]):
            col_sel[3 * mi: 3 * mi + 3, :k] = True
    uidx = torch.arange(col_sel.shape[0], device="cuda") % 3
    valid = universes[uidx].to(torch.uint8).contiguous()
    center = shared_center(x)
    return y, x, universes[uidx], valid, col_sel, center


def check_gram(t, n, p, dtype, rel, gen, timed, figure=False):
    y, x, uni, valid, col_sel, center = gram_inputs(t, n, p, dtype, gen, figure)
    s = col_sel.shape[0]
    window = torch.ones((s, t), dtype=torch.bool, device="cuda")
    got = split_stats(gram_contract_cuda(y, x, valid, col_sel, center), p)
    want = contract_spec_grams_plain(y, x, uni, col_sel, window, center)
    torch.cuda.synchronize()
    scale = torch.stack([
        want[0].abs().amax((-1, -2)), want[1].abs().amax(-1),
        want[2].abs(), want[3].abs(), want[4].abs(),
    ]).amax(0).clamp_min(1.0)                                   # (S, T)
    counts_exact = bool((got[2] == want[2]).all())
    worst, max_abs = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        block_scale = scale.reshape(scale.shape + (1,) * (d.dim() - 2))
        worst = max(worst, worst_of(d / block_scale))
        max_abs = max(max_abs, worst_of(d))
    label = f"T={t} N={n} P={p} S={s} {str(dtype)[6:]}"
    log(f"K2 {label}: max_abs={max_abs:.3e} worst_rel_to_block_max={worst:.3e} "
        f"tol={rel:g} counts_exact={counts_exact}")
    check(counts_exact, f"K2 {label}: counts differ from the plain version")
    check(worst <= rel, f"K2 {label}: error beyond tolerance")
    row = None
    if timed:
        ms = time_ms(lambda: gram_contract_cuda(y, x, valid, col_sel, center))
        plain_ms = time_ms(lambda: contract_spec_grams_plain(
            y, x, uni, col_sel, window, center), reps=5)
        # yardstick: ONE batched matmul over the pre-weighted augmented
        # design, every (spec, month) a (QE, N) @ (N, QE) product
        fin = torch.isfinite(x)
        xz = torch.where(fin, x - center[:, None, :], torch.zeros_like(x))
        finy = torch.isfinite(y)
        yz = torch.where(finy, y, torch.zeros_like(y))
        xa = torch.cat([torch.ones_like(y)[..., None], xz, yz[..., None]], -1)
        bad = torch.einsum("tnp,sp->stn", (~fin).to(dtype), col_sel.to(dtype))
        w = (uni & finy[None] & (bad == 0)).to(dtype)
        del fin, xz, yz, bad
        lhs = (xa[None] * w[..., None]).reshape(-1, n, p + 2).transpose(1, 2)
        rhs = xa[None].expand(s, t, n, p + 2).reshape(-1, n, p + 2).contiguous()
        lib = torch.bmm(lhs, rhs).reshape(s, t, p + 2, p + 2)
        lib_err = float((split_stats(lib, p)[0] - got[0]).abs().max())
        library_ms = time_ms(lambda: torch.bmm(lhs, rhs))
        del lhs, rhs, lib, w, xa
        tri = (p + 2) * (p + 3) // 2
        in_bytes = sum(a.numel() * a.element_size()
                       for a in (x, y, valid, col_sel, center))
        out_bytes = s * t * (p + 2) ** 2 * x.element_size()
        b_ms, b_by = bound(in_bytes + out_bytes, 2.0 * s * t * n * tri, dtype)
        log(f"K2 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library bmm {library_ms:.4f} ms (|gram diff| {lib_err:.3e}; "
            f"kernel/bmm {ms / library_ms:.3f}), bound {b_ms:.4f} ms ({b_by})")
        row = dict(name=f"gram_contract T={t} N={n} P={p} S={s} f32",
                   key=f"gram/P={p},S={s}", route="cuda", source=K2_SOURCE,
                   replaces=K2_REPLACES, max_abs_err=max_abs, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms)
    del y, x, uni, valid, col_sel, center, got, want
    torch.cuda.empty_cache()
    return row


def k2_phase(gen, timed: bool):
    rows = [check_gram(600, 22000, 14, torch.float32, 1e-5, gen, timed),
            check_gram(600, 22000, 5, torch.float32, 1e-5, gen, timed, figure=True)]
    check_gram(600, 3000, 14, torch.float64, 1e-12, gen, False)
    check_gram(240, 3000, 5, torch.float64, 1e-12, gen, False, figure=True)
    return [row for row in rows if row]


# --- K3: the masked cumulative moments --------------------------------------


def check_moments(x, rel: float, label: str, timed: bool):
    """The kernel against its plain version: counts exact, each sum within
    ``rel·|p| + 4·eps·C`` with C the cumulative Σ|x| (Σx² for the squares)
    through that row."""
    got = masked_cumulative_moments_cuda(x)
    want = masked_cumulative_moments_plain(x)
    torch.cuda.synchronize()
    eps = torch.finfo(x.dtype).eps
    c1, c2, _ = masked_cumulative_moments_plain(x.abs())
    counts_exact = bool(torch.equal(got[2], want[2]))
    worst, max_abs = 0.0, 0.0
    for g, w, c in zip(got[:2], want[:2], (c1, c2)):
        d = (g - w).abs()
        limit = (rel * w.abs() + 4 * eps * c).clamp_min(torch.finfo(x.dtype).tiny)
        worst = max(worst, worst_of(d / limit))
        max_abs = max(max_abs, worst_of(d))
    log(f"K3 {label}: max_abs={max_abs:.3e} tol=|d|<={rel:g}*|p|+4eps*C "
        f"worst_ratio={worst:.3f} counts_exact={counts_exact}")
    check(counts_exact, f"K3 {label}: counts differ from the plain version")
    check(worst <= 1.0, f"K3 {label}: error beyond tolerance")
    del got, want, c1, c2
    if not timed:
        return None
    ms = time_ms(lambda: masked_cumulative_moments_cuda(x))
    plain_ms = time_ms(lambda: masked_cumulative_moments_plain(x))
    # yardstick: ONE torch.cumsum over a pre-built masked (T, 3N) stack; it
    # skips the masking the kernel and the plain version do
    fin = torch.isfinite(x)
    xz = torch.where(fin, x, torch.zeros_like(x))
    stack = torch.cat([xz, xz * xz, fin.to(x.dtype)], dim=1)
    del fin, xz
    library_ms = time_ms(lambda: torch.cumsum(stack, dim=0))
    del stack
    b_ms, b_by = bound(4 * x.numel() * x.element_size(), 4 * x.numel(), x.dtype)
    log(f"K3 {label}: kernel {ms:.4f} ms ({b_ms / ms:.1%} of the bound), plain "
        f"{plain_ms:.4f} ms, library cumsum over a pre-masked (T, 3N) stack "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    t, n = x.shape
    return dict(name=f"masked_cumulative_moments {t}x{n} {str(x.dtype)[6:]}",
                key="moments", route="cuda", source=K3_SOURCE, replaces=K3_REPLACES,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, main_path=K3_MAIN_PATH)


def check_moments_repeat(x, label: str) -> None:
    """Two launches on the same input give the same bits: the two-pass scan
    adds in a fixed order and uses no atomics."""
    first = masked_cumulative_moments_cuda(x)
    second = masked_cumulative_moments_cuda(x)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"K3 {label}: two launches bit-identical={same}")
    check(same, f"K3 {label}: two launches on the same input differ")


def k3_phase(gen, timed: bool):
    rows = []
    for t, n, dtype, rel, scale, on_table in (
            (13312, 2432, torch.float32, 1e-4, 0.02, True),
            (600, 22000, torch.float32, 1e-4, 1.0, True),
            (13312, 2432, torch.float64, 1e-10, 0.02, True),
            # ragged: T not a multiple of the chunk, N not of 32
            (3001, 2437, torch.float32, 1e-4, 1.0, False),
            (3001, 2437, torch.float64, 1e-10, 1.0, False)):
        x = rolling_input(t, n, dtype, gen, scale, 0.02)
        label = f"{t}x{n} {str(dtype)[6:]}"
        log(f"K3 {label}: {len(moments_chunk_plan(t))} chunks of "
            f"{moments_chunk_rows(t)} rows")
        row = check_moments(x, rel, label, timed and on_table)
        if (t, n, dtype) == (13312, 2432, torch.float32):
            check_moments_repeat(x, label)
        if row:
            rows.append(row)
        del x
    torch.cuda.empty_cache()
    return rows


# --- the main path ---------------------------------------------------------


def reset_counts() -> None:
    rolling_reduce_cuda.launches = 0
    rolling_reduce_cuda.launches_by_key = {}
    gram_contract_cuda.launches = 0
    gram_contract_cuda.launches_by_key = {}
    masked_cumulative_moments_cuda.launches = 0


def main_path(seed: int):
    start = time.perf_counter()
    base, daily = make_smoke_inputs(seed=seed, dtype=np.float32)
    log(f"main path inputs: panel {base.values.shape} f32, "
        f"{len(daily.row_values):,} daily rows over {daily.n_days} days, "
        f"built in {time.perf_counter() - start:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    res = run_pipeline(base, daily, device="cuda", dtype=torch.float32)
    wall = time.perf_counter() - start
    # K1 is counted per kind, window and shape ("mean/w=120,600x15"); the
    # per-kind totals ("mean/w=120") are summed here
    by_shape = dict(rolling_reduce_cuda.launches_by_key)
    by_kind = {}
    for key, n in by_shape.items():
        kind = key.split(",")[0]
        by_kind[kind] = by_kind.get(kind, 0) + n
    counts = {"k1": rolling_reduce_cuda.launches,
              "k2": gram_contract_cuda.launches,
              "moments": masked_cumulative_moments_cuda.launches}
    counts.update(by_shape)
    counts.update(by_kind)
    counts.update({f"gram/{k}": v for k, v in gram_contract_cuda.launches_by_key.items()})
    log(f"main path wall {wall:.3f} s; stages (s): "
        + json.dumps({k: round(v, 4) for k, v in res.stage_seconds.items()}))
    log(f"main path peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"main path launches: K1 {counts['k1']} {by_kind} by shape {by_shape}, "
        f"K2 {counts['k2']} {dict(gram_contract_cuda.launches_by_key)}, "
        f"K3 {counts['moments']}")
    check(counts["k1"] > 0, "main path never launched the rolling kernel")
    check(by_kind.get("mean/w=120", 0) > 0,
          "main path never launched the rolling kernel's mean w=120 (Figure 1, forecasts)")
    check(counts["k2"] == 2, f"main path launched the Gram kernel {counts['k2']} times, "
          "not twice (Table 2's grid and the figure grid)")

    t2 = res.table_2
    finite = sum(int(np.isfinite(c["coef"]).sum() + np.isfinite(c["tstat"]).sum())
                 for c in res.table_2_cells.values())
    total = sum(2 * len(c["coef"]) for c in res.table_2_cells.values())
    log(f"Table 2 shape {t2.shape}; finite coef/tstat entries {finite}/{total}")
    log(t2.to_string())
    check(tuple(res.panel.values.shape) == (600, 22000, 27),
          f"enriched panel shape {tuple(res.panel.values.shape)}")
    check(t2.shape == (27, 9), f"Table 2 shape {t2.shape}")
    check(finite == total, "Table 2 has non-finite cells")
    check(all(c["mean_n"] > 0 and np.isfinite(c["mean_r2"])
              for c in res.table_2_cells.values()), "Table 2 N/R² not finite")

    t1 = res.table_1
    log(f"Table 1 shape {t1.shape}")
    log(t1.to_string())
    check(t1.shape == (15, 9), f"Table 1 shape {t1.shape}")
    for subset in res.subset_masks:
        has_n = t1[(subset, "N")].to_numpy() > 0
        for stat in ("Avg", "Std"):
            check(bool(np.isfinite(t1[(subset, stat)].to_numpy()[has_n]).all()),
                  f"Table 1 {subset} {stat} not finite where N > 0")
    dec = res.decile_table
    log(f"decile table shape {dec.shape}")
    log(dec.to_string())
    check(dec.shape == (13, 3), f"decile table shape {dec.shape}")
    check(bool((dec.loc["Months"].to_numpy() > 0).all()), "decile table: a universe has no months")
    check(bool(np.isfinite(dec.to_numpy(dtype=float)).all()), "decile table has non-finite cells")
    check(set(res.figure_1) == {"All stocks", "Large stocks"}, "Figure 1 frames missing")
    for name, frame in res.figure_1.items():
        rolled = frame.to_numpy()
        log(f"Figure 1 {name}: {frame.shape[0]} months, {int(np.isfinite(rolled).all(1).sum())} "
            f"with all five rolling slopes")
        check(frame.shape[1] == 5 and np.isfinite(rolled).all(1).any(),
              f"Figure 1 {name}: no finite rolling slopes")
    st = res.serving_state
    log(f"serving state coef {st.coef.shape}, months with a lagged coefficient mean "
        f"{int(st.have_coef().sum())}")
    check(st.coef.shape == (600, 6), f"serving state coef shape {st.coef.shape}")
    check(int(st.have_coef().sum()) > 0, "serving state has no quotable month")
    del res
    torch.cuda.empty_cache()
    return counts


def _cell_diffs(got: dict, ref: dict):
    """(held difference, plain relative difference, cell, number, index,
    reference value) for every Table 2 entry, worst held first, checking
    that the NaN patterns agree. A coefficient is held at its scale
    ``max(|b|, nw_se)`` and its t-stat at ``max(|t|, 1)`` — the same bound
    divided by the SE — so a statistically-zero coefficient is held at its
    standard error's scale; every other number at ``|b|``."""
    out = []
    for key, r in ref.items():
        se = np.atleast_1d(np.asarray(r["nw_se"], float))
        for name in ("coef", "tstat", "mean_r2", "mean_n"):
            a = np.atleast_1d(np.asarray(got[key][name], float))
            b = np.atleast_1d(np.asarray(r[name], float))
            check(bool((np.isnan(a) == np.isnan(b)).all()),
                  f"card vs CPU: NaN pattern of {key} {name}")
            for i in np.flatnonzero(np.isfinite(b)):
                diff = abs(a[i] - b[i])
                scale = abs(b[i])
                if name == "coef":
                    scale = max(scale, se[i])
                elif name == "tstat":
                    scale = max(scale, 1.0)
                out.append((float(diff / max(scale, 1e-300)),
                            float(diff / max(abs(b[i]), 1e-300)),
                            key, name, int(i), float(b[i])))
    return sorted(out, key=lambda d: d[0], reverse=True)


def _rel_worst(got: np.ndarray, want: np.ndarray, what: str) -> float:
    """Worst relative difference of two arrays whose NaN/inf patterns must
    agree (checked)."""
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    check(got.shape == want.shape, f"card vs CPU: {what} shape {got.shape} vs {want.shape}")
    check(all(np.array_equal(f(got), f(want)) for f in (np.isnan, np.isposinf, np.isneginf)),
          f"card vs CPU: {what} non-finite pattern differs")
    fin = np.isfinite(want)
    if not fin.any():
        return 0.0
    return float((np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1e-300)).max())


def _decile_count_flips(gpu, cpu) -> int:
    """Decile-count cells (subset, month, decile) that differ card vs CPU in
    the two runs' own sweeps: a firm changing decile moves one count
    between two cells."""
    check(list(gpu.sweep) == list(cpu.sweep), "card vs CPU: swept subsets differ")
    return sum(int(np.sum(np.asarray(gpu.sweep[name].deciles.decile_counts)
                          != np.asarray(entry.deciles.decile_counts)))
               for name, entry in cpu.sweep.items())


def _reporting_vs_cpu(gpu, cpu) -> None:
    """Table 1, the decile table, the figure frames and the serving state,
    card vs CPU."""
    t1g, t1c = gpu.table_1, cpu.table_1
    n_cols = [c for c in t1c.columns if c[1] == "N"]
    n_exact = bool((t1g[n_cols].to_numpy() == t1c[n_cols].to_numpy()).all())
    t1_worst = _rel_worst(t1g.drop(columns=n_cols).to_numpy(),
                          t1c.drop(columns=n_cols).to_numpy(), "Table 1")
    log(f"card vs CPU Table 1: Avg/Std worst rel diff {t1_worst:.3e} (tol 1e-10), "
        f"N exact {n_exact}")
    check(n_exact and t1_worst <= 1e-10, "card vs CPU: Table 1 beyond tolerance")

    flips = _decile_count_flips(gpu, cpu)
    dg, dc = gpu.decile_table, cpu.decile_table
    months_exact = bool((dg.loc["Months"].to_numpy() == dc.loc["Months"].to_numpy()).all())
    dec_worst = _rel_worst(dg.drop(index="Months").to_numpy(),
                           dc.drop(index="Months").to_numpy(), "decile table")
    log(f"card vs CPU decile table: worst rel diff {dec_worst:.3e} (tol 1e-8), Months "
        f"exact {months_exact}, decile-count cells that differ (flips) {flips}")
    check(months_exact and dec_worst <= 1e-8, "card vs CPU: decile table beyond tolerance")

    fig_worst = 0.0
    for name, frame in cpu.figure_1.items():
        check(gpu.figure_1[name].index.equals(frame.index), f"card vs CPU: Figure 1 {name} months")
        fig_worst = max(fig_worst, _rel_worst(gpu.figure_1[name].to_numpy(), frame.to_numpy(),
                                              f"Figure 1 {name}"))
    log(f"card vs CPU Figure 1 frames: worst rel diff {fig_worst:.3e} (tol 1e-8)")
    check(fig_worst <= 1e-8, "card vs CPU: Figure 1 frames beyond tolerance")

    sg, sc = gpu.serving_state, cpu.serving_state
    st_worst = max(_rel_worst(getattr(sg, k), getattr(sc, k), f"serving {k}")
                   for k in ("coef", "slopes_bar", "intercept_bar"))
    exact = {k: bool(np.array_equal(getattr(sg, k), getattr(sc, k)))
             for k in ("n_obs", "month_valid")}
    # the support bounds are minima/maxima of the enriched panel, which the
    # card computes in another order: they agree as closely as the panels do
    bounds = {k: _rel_worst(getattr(sg, k), getattr(sc, k), f"serving {k}")
              for k in ("x_lo", "x_hi")}
    bit_equal = {k: bool(np.array_equal(getattr(sg, k), getattr(sc, k))) for k in bounds}
    log(f"card vs CPU serving state: coef/slopes_bar/intercept_bar worst rel diff "
        f"{st_worst:.3e} (tol 1e-8); exact {exact}; support bounds worst rel diff "
        f"{bounds} (tol 1e-10), bit-equal {bit_equal}")
    check(st_worst <= 1e-8 and all(exact.values()) and max(bounds.values()) <= 1e-10,
          "card vs CPU: serving state beyond tolerance")


def card_vs_cpu(seed: int) -> None:
    base, daily = make_smoke_inputs(n_firms=3000, n_months=240, seed=seed + 1,
                                    dtype=np.float64)
    start = time.perf_counter()
    gpu = run_pipeline(base, daily, device="cuda", dtype=torch.float64)
    gpu_s = time.perf_counter() - start
    again = run_pipeline(base, daily, device="cuda", dtype=torch.float64)
    start = time.perf_counter()
    cpu = run_pipeline(base, daily, device="cpu", dtype=torch.float64)
    cpu_s = time.perf_counter() - start
    diffs = _cell_diffs(gpu.table_2_cells, cpu.table_2_cells)
    repeat = _cell_diffs(again.table_2_cells, gpu.table_2_cells)
    worst, plain, key, name, i, ref = diffs[0]
    plain_worst = max(diffs, key=lambda d: d[1])
    log(f"card vs CPU (T=240, N=3000, f64): cuda {gpu_s:.2f} s, cpu {cpu_s:.2f} s, "
        f"Table 2 worst held diff {worst:.3e} (tol 1e-8; coef at max(|b|, nw_se), t-stat "
        f"at max(|t|, 1)) at {key} {name}[{i}] = {ref:.6e} (plain rel {plain:.3e}); "
        f"worst plain rel diff {plain_worst[1]:.3e} at {plain_worst[2]} {plain_worst[3]}"
        f"[{plain_worst[4]}] = {plain_worst[5]:.6e}; card run-to-run worst plain rel diff "
        f"{max(d[1] for d in repeat):.3e}; formatted tables equal: "
        f"{gpu.table_2.equals(cpu.table_2)}")
    check(worst <= 1e-8, "card vs CPU: Table 2 beyond tolerance")
    _reporting_vs_cpu(gpu, cpu)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=20140131)
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check each kernel once, no timing")
    parser.add_argument("--ptxas", action="store_true",
                        help="print nvcc's register/shared-memory report")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is enabled")

    start = time.perf_counter()
    per_kernel = build_kernels(ptxas_verbose=args.ptxas)
    log(f"kernel build {time.perf_counter() - start:.2f} s "
        + json.dumps({k: round(v, 2) for k, v in per_kernel.items()}))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timed = not args.kernels_only
    rows = k1_phase(gen, timed) + k2_phase(gen, timed) + k3_phase(gen, timed)
    if args.kernels_only:
        log("kernels-only run: kernel phases passed")
        return 0

    counts = main_path(args.seed)
    rows += strip_phase(gen, counts)
    card_vs_cpu(args.seed)

    for row in rows:
        row["launches"] = counts.get(row.pop("key"), 0)
        if row.get("main_path") == K3_MAIN_PATH:
            check(row["launches"] == 0, f"{row['name']}: launched on the main path, "
                  "which has no caller of it")
            continue
        check(row["launches"] > 0, f"{row['name']} was not launched on the main path")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
