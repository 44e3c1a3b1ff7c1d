"""How far two fits of the same Level-2 measurements land apart.

The fitters end in constant-learning-rate Adam (2,000 projected steps for
the bases, 4,000 for the sigmoids), whose last steps wander around the
minimum, so a fit's parameters depend on every rounding on the way.
This script measures that sensitivity on fresh host timings, the same
data ``chip_smoke.py``'s search phase fits:

- ``ulp``: the CPU's fit of ``y`` against the CPU's fit of ``y`` moved
  up by one float32 ulp (the same data, one rounding changed);
- ``card`` (with ``--device cuda``): the card's fit against the CPU's
  fit of the same ``y``.

Each is the largest prediction gap over the measured sizes, divided by
``max |y|`` (the form of ``tests/test_torch_fit.py``'s 5e-3).  With
``--device cuda`` each card fit is also replayed on the CPU step by step
(``models.replay_gap``: ``replay_grad``, ``replay_update``), the check
``chip_smoke.py``'s search phase gates.

    PYTHONPATH=src python scripts/fit_spread.py --sets 8 \\
        [--device cuda] [--report out.json]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import access, models, training


def gap(a: models.FittedModel, b: models.FittedModel, x: np.ndarray,
        y: np.ndarray) -> float:
    scale = float(np.max(np.abs(y.astype(np.float32))))
    return float(np.max(np.abs(a.predict(x, "cpu") -
                               b.predict(x, "cpu")))) / scale


def one_set(device) -> dict:
    """Measure every fitted primitive once; the ``ulp`` (and ``card``)
    gap of each."""
    out = {}
    for pname, prim in access.LEVEL2.items():
        if prim.model_kind == "knn":     # no fit: the data themselves
            continue
        x, y = training.benchmark_primitive(prim)
        y32 = y.astype(np.float32)
        cpu = models.fit(prim.model_kind, x, y32, device="cpu")
        moved = models.fit(prim.model_kind, x,
                           np.nextafter(y32, np.float32(np.inf)),
                           device="cpu")
        row = {"kind": prim.model_kind, "ulp": gap(cpu, moved, x, y),
               "x": x.tolist(), "y": y.tolist()}
        if device is not None:
            record = {}
            card = models.fit(prim.model_kind, x, y32, device=device,
                              record=record)
            row["card"] = gap(card, cpu, x, y)
            replay = models.replay_gap(record, "cpu")
            row["replay_grad"] = replay["grad"]
            row["replay_update"] = replay["update"]
        out[pname] = row
    return out


def summary(sets, key: str, limit: float) -> dict:
    worst = [max(r[key] for r in s.values()) for s in sets]
    per = {p: max(s[p][key] for s in sets) for p in sets[0]}
    return {"set_max": worst, "limit": limit,
            "over_limit": sum(w > limit for w in worst),
            "sets": len(worst), "max_by_primitive": per}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sets", type=int, default=8,
                    help="fresh measurement sets")
    ap.add_argument("--device", default=None,
                    help="also fit on this device (cuda) and compare")
    ap.add_argument("--limit", type=float, default=5e-3)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    sets = []
    for i in range(args.sets):
        sets.append(one_set(args.device))
        worst = {k: max(r.get(k, 0.0) for r in sets[-1].values())
                 for k in ("ulp", "card", "replay_grad", "replay_update")}
        print(f"set {i}: {json.dumps(worst)}", flush=True)
    report = {"limit": args.limit, "device": args.device,
              "seconds": time.perf_counter() - t0,
              "ulp": summary(sets, "ulp", args.limit), "raw": sets}
    if args.device is not None:
        report["card"] = summary(sets, "card", args.limit)
        # chip_smoke.py's REPLAY_GRAD_TOL and REPLAY_UPDATE_TOL
        report["replay_grad"] = summary(sets, "replay_grad", 1e-4)
        report["replay_update"] = summary(sets, "replay_update", 1e-5)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "raw"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
