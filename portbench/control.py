"""Readings for the limits of a cell's comparison: the program's and the
control's, seed by seed, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed it builds the cell's inputs, runs the program's timed call once
and compares its answers with the float64 reference (the lower readings);
for each control seed it also puts the reference computed in float32 with
TF32 matrix products, the precision below the configuration's float32 with
TF32 off, in the program's place (the upper readings). One JSON line a seed.
The benchmark's own runs do not run this.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def readings(name: str, seed: int, control: bool, device: str = "cuda", sizes=None) -> dict:
    import torch

    from portbench.harness import load_cell, make_traffic

    _, work, cell, config = load_cell(name)
    cell = dict(cell, params=dict(cell["params"], warm_calls=0))
    drv = make_traffic(work, cell, config, seed, device, sizes)
    t0 = time.perf_counter()
    drv.setup()
    out = drv.call()
    got = drv.outputs(out)
    del out
    drv.release()
    ref = drv.reference(torch.float64, tf32=False)
    row = {"workload": name, "seed": seed, "program": drv.compare(got, ref)}
    if control:
        low = drv.reference(torch.float32, tf32=True)
        row["control"] = drv.compare(drv.as_answer(low), ref)
    row["seconds"] = time.perf_counter() - t0
    del drv, got, ref
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(args.workload, s, s in ctl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
