"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The last line of standard output is the run's result as one
JSON object; the checks that decide ``correct`` are the last lines of
standard error.  See ``portbench/harness/main.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
