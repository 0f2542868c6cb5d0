"""Run one cell of ``BENCHMARK.json`` on the card:

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; the numbers of the output check, each beside its limit,
are the last lines of standard error.
"""
import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout and the port's source, in place of this folder
sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], started=STARTED))
