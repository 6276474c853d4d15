"""The spawned spec-grid contraction worker (``specgrid.multiproc``'s child).

Usage: ``python -m fm_returnprediction_tpu_torch.specgrid.mp_worker
<paneldir>`` with ``FMRP_DIST_*``, ``FMRP_GRID_SHARD_*`` and
``FMRP_GRID_DEVICE`` in the environment (the pool spawns it through
``parallel.distributed.worker_env``). Joins the host exchange as rank
1..procs, loads its contiguous firm shard onto its device, and answers
contract jobs until the parent broadcasts stop.
"""

import sys

from fm_returnprediction_tpu_torch.parallel.distributed import apply_cpu_affinity_from_env

if __name__ == "__main__":
    # before torch sizes its thread pools
    apply_cpu_affinity_from_env()
    # a parent fault plan and trace context rode the spawn environment:
    # both are live before the exchange joins
    from fm_returnprediction_tpu_torch.resilience.faults import install_plan_from_env
    from fm_returnprediction_tpu_torch.telemetry.distributed import (
        install_remote_context_from_env,
    )

    install_plan_from_env()
    install_remote_context_from_env()
    from fm_returnprediction_tpu_torch.specgrid.multiproc import worker_main

    worker_main(sys.argv[1])
