#!/usr/bin/env python3
"""Probe what bounds K2's float32 kernels past 32 columns
(``gram_f32_wide_kernel`` and the tile-pair instance ``gram_f32_tiles_kernel``
in ``fm_returnprediction_tpu_torch/csrc/gram.cu``) on one GPU.

    python3 k2_probe.py [--shapes 40:22000,64:4096,100:4096] [--specs 9]
                        [--reps 7] [--seed N]
    python3 k2_probe.py --tiles [--tile-shape 920:60:22000] [--tile-specs 3]

Builds ``gram.cu`` as it is and variants of it with parts of the kernel cut
out (text edits of a copy, each compiled by ``nvcc`` in a temporary directory):

- ``as_built``: the kernel as committed;
- ``no_build``: the producers stage each tile and hand it over, but build
  nothing (no rows, no non-finite bits, no weights);
- ``phase1_off`` / ``phase2_off``: only the rows and non-finite bits, or
  only the weights, are not built;
- ``no_loads``: the consumers load their operands once a part and tile, not
  once a firm (the firm loop's FMAs on registers);
- ``neither``: ``no_build`` and ``no_loads`` together.

With ``--tiles`` the variants cut parts of the float32 tile-pair kernel
instead, each timed through its library's ``gram_tiles`` (the pre-pass's
folded mask made once beforehand) at ``--tile-shape`` P:T:N:

- ``as_built``; ``no_fma``: the producers stage and build every chunk, the
  consumers sum nothing; ``no_build``: the rows are not built (the firms'
  spec words are), the consumers sum stale rows; ``no_stage``: x is not
  staged (y, the row weights and the valid bytes are), the rows are built
  from stale stages; ``fma_only``: neither (the consumers' loads and FMAs,
  beside the staging of the valid bytes and the words; the words, and so
  the products skipped, are those of the data in every variant);
- ``months_fastest``: the kernel as built with the blocks dealt month
  first (the blocks resident together then hold one pair of many months,
  and no two read the same firms' columns), against the month-synchronous
  order as built (a month's pairs together, reading its firms from L2).

Each time is also given per block and 64-firm chunk (one block an SM: the
time × SMs / (blocks × chunks)), beside a chunk's FMAs at the FP32 peak
and the SM clock that ``nvidia-smi`` sampled.

The cut variants compute wrong sums: they are timed, never checked. Each is
timed through its library's ``gram_contract`` at T = 600 and each shape's
(P, N), S specs selecting the first 3, the first 7 and every column over
three universes (the kernel table's inputs), with CUDA events, the median
of ``--reps`` runs after a warm-up. Then a register-only 8×8 outer product
(64 FMAs a thread and step on loop-invariant operands: the consumers'
arithmetic alone) is timed at 4 and 16 warps an SM, against the card's
67 TFLOP/s FP32 peak. Prints the card's name and power limit, the SM clock
that ``nvidia-smi`` sampled during the run, and a last line of JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "fm_returnprediction_tpu_torch" / "csrc" / "gram.cu"

# (anchor, replacement) edits of gram.cu; every anchor must occur once
PHASE1 = ("for (int wd = 0; wd < nwr; ++wd) {\n      const int cc = cw * wd + c_lane;",
          "for (int wd = 0; wd < 0; ++wd) {\n      const int cc = cw * wd + c_lane;")
PHASE2 = ("for (int s = 0; s < nsb; ++s) {\n      for (int f = tid; f < cnt8; f += nprod) {",
          "for (int s = 0; s < 0; ++s) {\n      for (int f = tid; f < cnt8; f += nprod) {")
LOADS = [("ra + f * qp + half", "ra + half"), ("ra + f * qp)", "ra)"),
         ("rb + f * qp + half", "rb + half"), ("rb + f * qp)", "rb)"), ("= wr[f];", "= wr[0];")]
VARIANTS = {"as_built": [], "no_build": [PHASE1, PHASE2], "phase1_off": [PHASE1],
            "phase2_off": [PHASE2], "no_loads": LOADS, "neither": [PHASE1, PHASE2] + LOADS}
# the same for the float32 tile-pair instance
T_NO_FMA = ("    if (live) {\n      const unsigned char* built",
            "    if (false) {\n      const unsigned char* built")
T_NO_BUILD = ("  for (int side = 0; side < 2; ++side) {\n    const int a0 = of_side(B.base, side)",
              "  for (int side = 0; side < 0; ++side) {\n    const int a0 = of_side(B.base, side)")
T_NO_STAGE = [("    if (c >= B.xn[side]) continue;\n    const float* src = x + row0 * p",
               "    if (true) continue;\n    const float* src = x + row0 * p")]
T_MONTHS = ("""  const long long b = blockIdx.x;
  const long long rest = b / groups;
  const int k = (int)(rest % npairs);
  B.t = (int)(rest / npairs);""", """  const long long months = gridDim.x / ((long long)npairs * groups);
  B.t = (int)(blockIdx.x % months);
  const long long b = blockIdx.x / months;
  const long long rest = b / groups;
  const int k = (int)(rest % npairs);""")
TILE_VARIANTS = {"as_built": [], "no_fma": [T_NO_FMA], "no_build": [T_NO_BUILD],
                 "no_stage": T_NO_STAGE, "fma_only": [T_NO_BUILD] + T_NO_STAGE,
                 "months_fastest": [T_MONTHS]}

FFMA = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(512, 1) outer8x8(const float* in, float* out, int iters) {
  float a[8], b[8], part[64];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = in[(threadIdx.x + i) & 255];
    b[i] = in[(3 * threadIdx.x + i) & 255];
  }
#pragma unroll
  for (int q = 0; q < 64; ++q) part[q] = 0.f;
#pragma unroll 2
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[8 * i + j] = fmaf(a[i], b[j], part[8 * i + j]);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 64; ++q) s += part[q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(const float* in, float* out, int blocks, int threads, int iters) {
  outer8x8<<<blocks, threads>>>(in, out, iters);
  return (int)cudaGetLastError();
}
"""
FP32_PEAK = 67e12


def variant_source(edits) -> str:
    src = SOURCE.read_text()
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"gram.cu no longer holds the probe's anchor {anchor!r}")
        src = src.replace(anchor, new)
    return src


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build(sources: dict, out_dir: Path) -> dict:
    """One nvcc a source, all started together; name -> loaded library."""
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"{name}.so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{output[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def gram_case(p: int, n: int, s: int, gen):
    t = 600
    x = torch.randn((t, n, p), generator=gen, device="cuda")
    x = torch.where(torch.rand((t, n, p), generator=gen, device="cuda") < 0.05,
                    torch.full_like(x, float("nan")), x)
    y = 0.1 * torch.randn((t, n), generator=gen, device="cuda")
    y = torch.where(torch.rand((t, n), generator=gen, device="cuda") < 0.1,
                    torch.full_like(y, float("nan")), y)
    universes = torch.rand((3, t, n), generator=gen, device="cuda") > \
        torch.tensor([0.1, 0.4, 0.7], device="cuda")[:, None, None]
    col_sel = torch.zeros((s, p), dtype=torch.bool, device="cuda")
    for i in range(s):
        col_sel[i, :[3, 7, p][(i // 3) % 3]] = True
    valid = universes[torch.arange(s, device="cuda") % 3].to(torch.uint8).contiguous()
    fin = torch.isfinite(x)
    center = torch.where(fin, x, torch.zeros_like(x)).sum(1) / fin.sum(1).clamp_min(1)
    words = -(-p // 32)
    bits = torch.zeros((s, words * 32), dtype=torch.int64, device="cuda")
    bits[:, :p] = col_sel.to(torch.int64)
    sel = (bits.reshape(s, words, 32) * (2 ** torch.arange(32, device="cuda"))).sum(-1)
    sel = torch.where(sel >= 2**31, sel - 2**32, sel).to(torch.int32).contiguous()
    return y, x, valid, sel, center.contiguous()


def tile_probe(args, card: str) -> int:
    """Time the float32 tile-pair instance's cut variants (``--tiles``)."""
    from fm_returnprediction_tpu_torch.specgrid import grams

    p, t, n = (int(v) for v in args.tile_shape.split(":"))
    s = args.tile_specs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    x = torch.randn((t, n, p), generator=gen, device="cuda")
    x = torch.where(torch.rand((t, n, p), generator=gen, device="cuda") < 1e-4,
                    torch.full_like(x, float("nan")), x)
    y = 0.1 * torch.randn((t, n), generator=gen, device="cuda")
    universes = torch.rand((3, t, n), generator=gen, device="cuda") > \
        torch.tensor([0.1, 0.4, 0.7], device="cuda")[:, None, None]
    col_sel = torch.zeros((s, p), dtype=torch.bool, device="cuda")
    for i in range(s):
        col_sel[i, :(3, p // 2, p)[i % 3]] = True
    valid = universes[torch.arange(s, device="cuda") % 3].to(torch.uint8).contiguous()
    folded = grams.gram_fold_plain(y, x, valid, col_sel).contiguous()
    center = grams.shared_center(x).contiguous()
    plan = grams.gram_tile_plan(p, torch.float32, s)
    pairs = torch.tensor(plan.pairs, dtype=torch.int32, device="cuda")
    out = torch.zeros((s, t, p + 2, p + 2), device="cuda")
    blocks = t * len(plan.pairs) * plan.groups
    chunks = -(-n // 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = build({name: variant_source(edits) for name, edits in TILE_VARIANTS.items()},
                     Path(tmp))
        clocks = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader",
                                   "-lms", "200"], stdout=subprocess.PIPE, text=True)
        stream = torch.cuda.current_stream().cuda_stream
        row = {}
        for name in TILE_VARIANTS:
            fn = libs[name].gram_tiles
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

            def call(fn=fn):
                status = fn(0, x.data_ptr(), y.data_ptr(), None, folded.data_ptr(),
                            center.data_ptr(), out.data_ptr(), t, n, p, s, pairs.data_ptr(),
                            len(plan.pairs), plan.cols, plan.spec_group, stream)
                if status != 0:
                    raise RuntimeError(f"gram_tiles returned {status}")
            ms = median_ms(call, args.reps)
            row[name] = {"ms": ms, "us_a_block_chunk": ms * 1e3 * sms / (blocks * chunks)}
            print(f"tile pairs T={t} N={n} P={p} S={s} float32 {name}: {ms:.3f} ms, "
                  f"{row[name]['us_a_block_chunk']:.3f} us a block and chunk", flush=True)
        clocks.terminate()
        samples = [float(v.split()[0]) for v in clocks.communicate()[0].split("\n")
                   if v.strip().endswith("MHz")]
    fma_us = 64 * 64 * 64 * plan.spec_group / (128 * float(np.median(samples)) * 1e6) * 1e6
    print(f"clocks.sm during the run (MHz): median {np.median(samples):.0f}; a chunk's "
          f"{64 * 64 * 64 * plan.spec_group:,} FMAs take {fma_us:.3f} us on one SM at that clock")
    print(card)
    print(json.dumps({"card": card, "tile_shape": args.tile_shape, "specs": s,
                      "blocks": blocks, "chunks": chunks, "tile_variants": row,
                      "chunk_fma_us": fma_us, "clocks_sm_median_mhz": float(np.median(samples))}))
    return 0


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", default="40:22000,64:4096,100:4096",
                        help="comma-separated P:N")
    parser.add_argument("--specs", type=int, default=9)
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--seed", type=int, default=20140131)
    parser.add_argument("--tiles", action="store_true",
                        help="probe the float32 tile-pair instance instead")
    parser.add_argument("--tile-shape", default="920:60:22000", help="P:T:N")
    parser.add_argument("--tile-specs", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if args.tiles:
        return tile_probe(args, card)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp)
        sources = {name: variant_source(edits) for name, edits in VARIANTS.items()}
        sources["ffma"] = FFMA
        libs = build(sources, out_dir)
        clocks = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader",
                                   "-lms", "200"], stdout=subprocess.PIPE, text=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        stream = torch.cuda.current_stream().cuda_stream
        results = {}
        for shape in args.shapes.split(","):
            p, n = (int(v) for v in shape.split(":"))
            y, x, valid, sel, center = gram_case(p, n, args.specs, gen)
            out = torch.zeros((args.specs, 600, p + 2, p + 2), device="cuda")
            row = {}
            for name in VARIANTS:
                fn = libs[name].gram_contract
                fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

                def call(fn=fn):
                    status = fn(0, x.data_ptr(), y.data_ptr(), None, valid.data_ptr(),
                                sel.data_ptr(), center.data_ptr(), out.data_ptr(), 600, n, p,
                                args.specs, stream)
                    if status != 0:
                        raise RuntimeError(f"gram_contract returned {status}")
                row[name] = median_ms(call, args.reps)
            results[f"P={p},N={n},S={args.specs}"] = row
            print(f"T=600 N={n} P={p} S={args.specs} float32: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in row.items()), flush=True)
            del y, x, valid, sel, center, out
        run = libs["ffma"].run
        run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        inp = torch.rand(256, device="cuda")
        buf = torch.empty(sms * 512, device="cuda")
        ffma = {}
        for warps in (4, 16):
            iters = 20000
            ms = median_ms(lambda: run(inp.data_ptr(), buf.data_ptr(), sms, 32 * warps, iters),
                           args.reps)
            rate = 2.0 * 64 * iters * 32 * warps * sms / (ms * 1e-3)
            ffma[f"{warps} warps an SM"] = rate / FP32_PEAK
            print(f"register-only 8x8 outer product, {warps} warps an SM: {ms:.3f} ms, "
                  f"{rate / 1e12:.1f} TFLOP/s, {rate / FP32_PEAK:.3f} of 67 TFLOP/s", flush=True)
        clocks.terminate()
        samples = [float(v.split()[0]) for v in clocks.communicate()[0].split("\n")
                   if v.strip().endswith("MHz")]
    print(f"clocks.sm during the run (MHz): median {np.median(samples):.0f}, max "
          f"{max(samples):.0f} ({len(samples)} samples)")
    print(card)
    print(json.dumps({"card": card, "kernel_ms": results, "ffma_share_of_peak": ffma,
                      "clocks_sm_median_mhz": float(np.median(samples))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
