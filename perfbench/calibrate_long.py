"""The readings a ``prefill_long`` cell's limits are set from, on the card at
the cell's own size, in one process: ``calibrate.py``'s prefill readings
with the reference the ``prefill_long`` driver takes.

    python3 perfbench/calibrate_long.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3]

For every seed, the program's numbers (as a run compares them, without
the measured window); for each control seed, the control's (the
reference in float8 put in the program's place).  One JSON line a
reading, then a summary: each number's largest program reading and
smallest control reading.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.path.insert(1, os.path.join(ROOT, "src"))

from perfbench import calibrate, harness  # noqa: E402


def main():
    from perfbench.drivers import prefill_long
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=calibrate._seeds, required=True)
    ap.add_argument("--control-seeds", type=calibrate._seeds, default=[])
    args = ap.parse_args()
    harness.prepare_env(harness.Path(ROOT))
    cell = harness.Cell.load(harness.Path(ROOT), args.workload)
    dev = harness.pick_device(cell.chips, None)
    summary = {}
    for seed in args.seeds:
        kinds = {"control"} if seed in args.control_seeds else set()
        t = time.perf_counter()
        with prefill_long.this_reference():
            got = calibrate.prefill_readings(cell, dev, seed, kinds)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t,
                          **got}), flush=True)
        for kind, values in got.items():
            for name, v in values.items():
                s = summary.setdefault(name, {})
                pick = max if kind == "program" else min
                s[kind] = v if kind not in s else pick(s[kind], v)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
