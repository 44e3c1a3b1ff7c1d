"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (JSON); the last
lines of standard error are the numbers compared, each beside its limit.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.prepare_env(harness.Path(ROOT))
    sys.exit(harness.main(sys.argv[1:], T0))
