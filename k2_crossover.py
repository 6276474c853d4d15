#!/usr/bin/env python3
"""Time K2's tile-pair kernel against the one-launch kernels on one GPU, to
place the width from which each operand type's unions take the tile route
(``specgrid.grams.GRAM_TILE_FROM``).

    python3 k2_crossover.py [--reps 5] [--seed N] [--specs 3,9]
                            [--dtypes float32,float64,bfloat16]

At T = 60 months and N = 22,000 firms, for each operand type, union width P
and spec count S (specs select the first 3 columns, the first half and
every column in turn, over three universes, as ``chip_smoke.gram_inputs``
makes them), the same inputs go through ``gram_contract_cuda`` twice: with
``GRAM_TILE_FROM`` set so that the call takes the tile route (the pre-pass
and one launch of ``gram_f32_tiles_kernel`` / ``gram_dmma_tiles_kernel`` /
``gram_tc_tiles_kernel``), and so that it takes the one-launch kernel
(``gram_f32_wide_kernel``, ``gram_dmma_kernel``, ``gram_tc_wide_kernel``)
where one launch reaches that width. Each is timed
with CUDA events, the median of ``--reps`` runs after a warm-up, in the
order tile, one launch, one launch, tile (the two medians of each route
averaged), and the two routes' blocks are compared (the largest difference
relative to each block's largest entry). Prints the card's name and power
limit, a line a reading, and a last line of JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from fm_returnprediction_tpu_torch.cuda_build import build_kernels
from fm_returnprediction_tpu_torch.specgrid import grams

T, N = 60, 22000
WIDTHS = {torch.float32: (101, 128, 160, 200, 256, 300, 424, 512, 640, 848),
          torch.float64: (64, 100, 128, 160, 200, 300, 424, 920),
          torch.bfloat16: (64, 100, 128, 160, 256, 512, 920)}
NEVER = 10**9


def inputs(p: int, s: int, dtype, gen):
    x = torch.randn((T, N, p), generator=gen, device="cuda")
    x = torch.where(torch.rand((T, N, p), generator=gen, device="cuda") < 1e-4,
                    torch.full_like(x, float("nan")), x)
    y = 0.1 * torch.randn((T, N), generator=gen, device="cuda")
    universes = torch.rand((3, T, N), generator=gen, device="cuda") > \
        torch.tensor([0.1, 0.4, 0.7], device="cuda")[:, None, None]
    col_sel = torch.zeros((s, p), dtype=torch.bool, device="cuda")
    for i in range(s):
        col_sel[i, :(3, p // 2, p)[i % 3]] = True
    valid = universes[torch.arange(s, device="cuda") % 3].to(torch.uint8).contiguous()
    center = grams.shared_center(x)
    x, y, center = (a.to(dtype).contiguous() for a in (x, y, center))
    return y, x, valid, col_sel, center


def time_ms(fn, reps: int) -> float:
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


def on_route(dtype, start: int, fn):
    before = grams.GRAM_TILE_FROM[dtype]
    grams.GRAM_TILE_FROM[dtype] = start
    try:
        return fn()
    finally:
        grams.GRAM_TILE_FROM[dtype] = before


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=20140131)
    parser.add_argument("--specs", default="3,9")
    parser.add_argument("--dtypes", default="float32,float64,bfloat16")
    args = parser.parse_args(argv)
    dtypes = [getattr(torch, name) for name in args.dtypes.split(",")]
    if not torch.cuda.is_available():
        print("k2_crossover: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    build_kernels(["gram"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    readings = []
    for dtype in dtypes:
        for p in WIDTHS[dtype]:
            for s in (int(v) for v in args.specs.split(",")):
                y, x, valid, col_sel, center = inputs(p, s, dtype, gen)

                def call():
                    return grams.gram_contract_cuda(y, x, valid, col_sel, center)

                tile = lambda: on_route(dtype, 0, call)  # noqa: E731
                one = lambda: on_route(dtype, NEVER, call)  # noqa: E731
                fits = on_route(dtype, NEVER, lambda: grams.gram_launch_fits(p, dtype, s))
                tile_ms = [time_ms(tile, args.reps)]
                one_ms, gap = [], None
                if fits:
                    one_ms = [time_ms(one, args.reps), time_ms(one, args.reps)]
                    a, b = tile(), one()
                    scale = b.abs().amax((-1, -2), keepdim=True).clamp_min(1.0)
                    gap = float(((a.double() - b.double()).abs() / scale).max())
                    del a, b
                tile_ms.append(time_ms(tile, args.reps))
                row = dict(dtype=str(dtype)[6:], p=p, specs=s,
                           tile_ms=float(np.mean(tile_ms)),
                           one_launch_ms=float(np.mean(one_ms)) if one_ms else None,
                           worst_rel_to_block_max=gap)
                readings.append(row)
                print(json.dumps(row), flush=True)
                del y, x, valid, col_sel, center
                torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"device": smi, "T": T, "N": N, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
