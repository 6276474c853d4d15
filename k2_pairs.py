#!/usr/bin/env python3
"""Time this checkout's K2 wrapper against another checkout's on one GPU,
in alternating pairs.

    python3 k2_pairs.py OTHER_CHECKOUT [--pairs 10] [--reps 7] [--seed N]
                       [--p 14] [--specs 9] [--dtype float32|float64|bfloat16]

Each checkout gets a worker process whose working directory, and so whose
``fm_returnprediction_tpu_torch``, is its own root. A worker builds its
Gram kernel, makes the contraction inputs (T=600, N=22,000; by default
Table 2's P=14, S=9 in float32; the same from the same seed in both; specs
select the first 3, the first 7 and every column in turn, over three
universes; bfloat16 operands are the float32 inputs rounded) and then, on
each request, times ``gram_contract_cuda`` with CUDA events: ``--reps``
runs after a warm-up call. The workers are asked in the order other, this /
this, other / ... so a drift in the card's speed falls on both. Prints
each pair's medians and their ratio, the medians over all runs, the card's
name and power limit, and a last line of JSON with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

WORKER = r"""
import json, sys
import torch
from fm_returnprediction_tpu_torch.cuda_build import build_kernels
from fm_returnprediction_tpu_torch.specgrid.grams import gram_contract_cuda, shared_center

build_kernels(["gram"])
t, n = 600, 22000
p, s, dtype = int(sys.argv[2]), int(sys.argv[3]), getattr(torch, sys.argv[4])
gen = torch.Generator(device="cuda")
gen.manual_seed(int(sys.argv[1]))
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
center = shared_center(x)
if dtype != torch.float32:
    x, y, center = (a.to(dtype) for a in (x, y, center))
torch.cuda.synchronize()
print("ready", flush=True)
for line in sys.stdin:
    gram_contract_cuda(y, x, valid, col_sel, center)
    torch.cuda.synchronize()
    times = []
    for _ in range(int(line)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gram_contract_cuda(y, x, valid, col_sel, center)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(json.dumps(times), flush=True)
"""


def start_worker(root: Path, seed: int, shape: tuple) -> subprocess.Popen:
    proc = subprocess.Popen([sys.executable, "-c", WORKER, str(seed), *map(str, shape)],
                            cwd=root,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    if proc.stdout.readline().strip() != "ready":
        proc.kill()
        raise RuntimeError(f"the worker in {root} did not start (exit {proc.wait()})")
    return proc


def ask(proc: subprocess.Popen, reps: int) -> list:
    proc.stdin.write(f"{reps}\n")
    proc.stdin.flush()
    return json.loads(proc.stdout.readline())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="root of the other checkout")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--seed", type=int, default=20140131)
    parser.add_argument("--p", type=int, default=14, help="predictor columns")
    parser.add_argument("--specs", type=int, default=9)
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "float64", "bfloat16"))
    args = parser.parse_args(argv)
    shape = (args.p, args.specs, args.dtype)
    roots = {"other": args.other.resolve(), "this": Path(__file__).resolve().parent}
    workers = {}
    try:
        for name, root in roots.items():
            workers[name] = start_worker(root, args.seed, shape)
        runs = {name: [] for name in roots}
        pairs = []
        for i in range(args.pairs):
            order = ("other", "this") if i % 2 == 0 else ("this", "other")
            pair = {}
            for name in order:
                times = ask(workers[name], args.reps)
                runs[name] += times
                pair[name] = float(np.median(times))
            pairs.append(pair)
            print(f"pair {i} ({order[0]} first): other {pair['other']:.4f} ms, this "
                  f"{pair['this']:.4f} ms, this / other {pair['this'] / pair['other']:.4f}",
                  flush=True)
    finally:
        for proc in workers.values():
            proc.stdin.close()
            proc.wait(timeout=60)
    medians = {name: float(np.median(t)) for name, t in runs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"gram_contract_cuda T=600 N=22000 P={args.p} S={args.specs} {args.dtype}, "
          f"{args.pairs} pairs x {args.reps} "
          f"runs: median other {medians['other']:.4f} ms, this {medians['this']:.4f} ms, "
          f"this / other {medians['this'] / medians['other']:.4f}; this faster in "
          f"{sum(p['this'] < p['other'] for p in pairs)} of {args.pairs} pairs")
    print(card.strip())
    print(json.dumps({"shape": {"p": args.p, "specs": args.specs, "dtype": args.dtype},
                      "medians_ms": medians, "pairs": pairs,
                      "roots": {k: str(v) for k, v in roots.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
