"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] \
        [--unchanged-seeds 1,2,3]

For every seed, the program's numbers (as a run compares them, without
the measured window); for each control seed, the control's: the
reference in float8 put in the program's place; for each fault seed, a
training cell's numbers with half of each checked batch left out and
the mean taken over the rest; for each unchanged seed, with a step that
returns its state unchanged.  One JSON line a reading, then a summary:
each number's largest program reading (the lower end of its limit) and
the smallest control and fault readings (the upper end).  The benchmark's
own runs never run this.
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

from perfbench import harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def train_readings(cell, dev, seed, kinds):
    from perfbench.drivers import common, train
    got = train.checked_steps(cell, dev, seed)
    data = [got["batch"](j) for j in range(int(cell.traffic["checked_steps"]))]
    del got["state"], got["step"]
    common.free_device()
    ref = train.reference(cell, got["spec"], seed, dev, data)
    out = {"program": train.judge(got, ref)}
    if "control" in kinds:
        low = train.reference(cell, got["spec"], seed, dev, data,
                              precision="fp8")
        out["control"] = train.judge(low, ref)
    for kind in ("fault", "unchanged"):
        if kind in kinds:
            with broken_step(kind):
                bad = train.checked_steps(cell, dev, seed)
            del bad["state"], bad["step"]
            common.free_device()
            out[kind] = train.judge(bad, ref)
    return out


class broken_step:
    """The program's training step broken underneath: ``"fault"`` gives
    it the first half of each batch's rows (its loss the mean over them),
    ``"unchanged"`` returns the state it was given."""

    def __init__(self, kind: str) -> None:
        self.kind = kind

    def __enter__(self):
        from repro_torch.train import loop
        self.loop, self.step = loop, loop.train_step

        def half(state, batch, model, run):
            rows = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return self.step(state, rows, model, run)

        def unchanged(state, batch, model, run):
            return state, self.step(state, batch, model, run)[1]
        loop.train_step = half if self.kind == "fault" else unchanged

    def __exit__(self, *exc):
        self.loop.train_step = self.step


def prefill_readings(cell, dev, seed, kinds):
    from perfbench.drivers import common, prefill
    from perfbench.yardstick import compare, traffic
    cfg, _, spec, params = common.program(cell, seed, dev)
    serve = prefill.server(cell, cfg, params)
    prefill.warm_up(cell, seed, serve)
    served, j = {}, 0
    schedule = traffic.length_schedule(seed, cell.traffic["lengths"],
                                       cell.traffic["per_block"])
    while len(served) < int(cell.traffic["checked_batches"]):
        for length in next(schedule):
            served[j] = (length, serve(prefill.prompts(cell, seed, j,
                                                       length))[:, 0])
            j += 1
    del serve, params
    common.free_device()
    picked = prefill.sample(cell, seed, served)
    out = {}
    for kind, precision in (("program", "float32"), ("control", "fp8")):
        if kind == "program" or kind in kinds:
            gaps = prefill.reference_gaps(cell, spec, seed, dev, served,
                                          picked, precision)
            out[kind] = compare.gap_stats([g for gs in gaps.values()
                                           for g in gs])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--unchanged-seeds", type=_seeds, default=[])
    args = ap.parse_args()
    harness.prepare_env(harness.Path(ROOT))
    cell = harness.Cell.load(harness.Path(ROOT), args.workload)
    dev = harness.pick_device(cell.chips, None)
    readings = {"train": train_readings,
                "prefill": prefill_readings}[cell.traffic["kind"]]
    summary = {}
    for seed in args.seeds:
        kinds = {k for k, s in (("control", args.control_seeds),
                                ("fault", args.fault_seeds),
                                ("unchanged", args.unchanged_seeds))
                 if seed in s}
        t = time.perf_counter()
        got = readings(cell, dev, seed, kinds)
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
