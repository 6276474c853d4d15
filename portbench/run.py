"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell needs is found by its name:
``BENCHMARK.json`` names its configuration, its traffic (the module
``portbench/traffic/<traffic>.py``) and its metrics,
``portbench/cells/<cell>.json`` its parameters and the limits of its
comparison, ``portbench/configs/<config>.json`` its sizes, and
``portbench/metrics/<metric>.py`` the reader of each metric.
"""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], _T0))
