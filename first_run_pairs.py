#!/usr/bin/env python3
"""Time the first and second real-size main-path runs of a process, for
this checkout and another one, on one GPU, in alternating order.

    python3 first_run_pairs.py OTHER_CHECKOUT [--pairs 2] [--seed N]

Each run is a fresh process whose working directory, and so whose
``fm_returnprediction_tpu_torch``, is its checkout's root. It builds the
kernels, makes the real-size prepared inputs (600 months × 22,000 firms,
``data.smoke_inputs``, float32, the same from the same seed in both), runs
``run_pipeline`` guarded twice, and prints each run's wall and stage seconds.
The checkouts run in the order other, this / this, other / ... so a drift in
the card's speed falls on both. Prints one line per process, the card's
name and power limit, and a last line of JSON with every reading: what a
call's first run pays above its second, stage by stage, in each checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

WORKER = r"""
import json, sys, time
import numpy as np
import torch
from fm_returnprediction_tpu_torch.cuda_build import build_kernels
from fm_returnprediction_tpu_torch.data.smoke_inputs import make_smoke_inputs
from fm_returnprediction_tpu_torch.pipeline import run_pipeline

build_kernels()
base, daily = make_smoke_inputs(seed=int(sys.argv[1]), dtype=np.float32)
out = []
for _ in range(2):
    start = time.perf_counter()
    res = run_pipeline(base, daily, device="cuda", dtype=torch.float32, guard=True)
    torch.cuda.synchronize()
    out.append({"wall": time.perf_counter() - start, "stages": res.stage_seconds})
    del res
print("RUNS " + json.dumps(out), flush=True)
"""


def run_worker(root: Path, seed: int) -> list:
    done = subprocess.run([sys.executable, "-c", WORKER, str(seed)], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if done.returncode != 0:
        raise RuntimeError(f"the worker in {root} exited {done.returncode}: "
                           f"{done.stderr[-2000:]}")
    return json.loads(done.stdout.split("RUNS ", 1)[1].splitlines()[0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="root of the other checkout")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=20140131)
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent
    roots = {"other": args.other.resolve(), "this": here}
    readings = {"other": [], "this": []}
    for i in range(args.pairs):
        for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
            start = time.perf_counter()
            runs = run_worker(roots[name], args.seed)
            readings[name].append(runs)
            first, second = runs
            print(f"{name}: process {time.perf_counter() - start:.1f} s; first run "
                  f"{first['wall']:.3f} s, second {second['wall']:.3f} s; table_2 "
                  f"{first['stages']['table_2']:.4f} / {second['stages']['table_2']:.4f} s; "
                  f"first run stages {json.dumps({k: round(v, 4) for k, v in first['stages'].items()})}",
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"device": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
