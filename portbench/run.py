"""Run one cell of the benchmark of lzw_tpu_torch once, on this machine's
CUDA devices, and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See :mod:`portbench.harness`.
"""

import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    # The checkout's root, not this directory, is where imports start.
    sys.path[0] = str(ROOT)
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
