"""One run of one cell: find its configuration, traffic, limits and metric
readers by the names in ``BENCHMARK.json``, run its driver, and print the
result line.

A cell's traffic file names its ``kind``; the driver of that kind
(``perfbench/drivers/<kind>.py``) sets the program up, measures the
window (or, with ``--trace 1``, traces a few steps of it), and checks
what the timed path produced against the plain reference.  A per-layer
metric is ``perfbench/metrics/<metric>.py``, whose ``read(reading)``
returns the number or None when the run gave it nothing to read; a
metric with no number is left out of the line.

The run needs as many CUDA cards as the cell asks for and exits with
code 2, printing no result, when they are not there.  It exits with code
3, printing no result, when JAX, jaxlib, flax or the JAX package is in
``sys.modules`` once the drivers and readers have run.  ``main(...,
device="cpu")`` exists for the CPU tests alone: it runs the same steps
on the CPU at a test's size, and every time, rate and share of the
device then reads "not measured".
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

NOT_MEASURED = "not measured"

#: the program's config fields each published key is held to
PORT_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "head_dim": "resolved_head_dim",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "qkv_bias": "qkv_bias"}
PORT_MOE_FIELDS = {"num_local_experts": "n_experts",
                   "num_experts_per_tok": "top_k",
                   "capacity_factor": "capacity_factor"}


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module)."""

    def __init__(self, message: str, code: int) -> None:
        super().__init__(message)
        self.code = code


def prepare_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    set before torch or Triton is imported."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The cell and its files
# ---------------------------------------------------------------------------
def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` and the files it names."""

    root: Path
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        bench = _read_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have: {', '.join(cells)})")
        w = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        config = _read_json(root / configs[w["config"]]["file"])
        bench_dir = root / "perfbench"
        traffic = _read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
        limits = _read_json(bench_dir / "limits" / f"{name}.json")
        return cls(root, name, int(w["chips"]), config, traffic,
                   {k: float(v["limit"]) for k, v in limits.items()},
                   [m for m in bench["end_to_end"] if _for_cell(m, name)],
                   [m for m in bench["per_layer"] if _for_cell(m, name)])

    def reader(self, metric: str):
        """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
        path = self.root / "perfbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def port_config(self):
        """The program's config of this cell: its registered architecture
        with the configuration's overrides, held to the published numbers
        the configuration states."""
        from repro_torch.configs import get_config
        port = self.config["port"]
        cfg = get_config(port["arch"])
        over = dict(port.get("overrides", {}))
        if "moe" in over:
            over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
        cfg = dataclasses.replace(cfg, **over)
        model = self.config["model"]
        wrong = []
        for key, field in PORT_FIELDS.items():
            if key in model and getattr(cfg, field) != model[key]:
                wrong.append(f"{key}: file {model[key]} program "
                             f"{getattr(cfg, field)}")
        for key, field in PORT_MOE_FIELDS.items():
            if key in model and getattr(cfg.moe, field) != model[key]:
                wrong.append(f"{key}: file {model[key]} program "
                             f"{getattr(cfg.moe, field)}")
        for key, field in (("param", "param_dtype"),
                           ("compute", "compute_dtype")):
            if getattr(cfg, field) != self.config["dtypes"][key]:
                wrong.append(f"{field}: file {self.config['dtypes'][key]} "
                             f"program {getattr(cfg, field)}")
        if wrong:
            raise SystemExit("the program's config departs from "
                             f"{self.config['name']}: " + "; ".join(wrong))
        return cfg


# ---------------------------------------------------------------------------
# What a metric reader reads
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Reading:
    """A traced run, as the per-layer readers see it.  ``steps`` are the
    traced steps (``batch``, ``seq`` and ``tokens`` each) and
    ``step_spans`` their host spans in the trace, in the same order;
    ``trace`` is None and ``peaks`` None where there is nothing of the
    device to read.  ``window_steps`` are the steps of the untraced
    window that the run measures before it traces, in the same form, and
    ``window_s`` its length on the host clock: the profiler's own host
    cost is in the traced steps' spans and not in it.  The traced steps
    are drawn like the window's, so the window holds whole multiples of
    their mix."""

    model: Dict
    steps: List[Dict]
    trace: Any = None
    step_spans: Optional[List] = None
    peaks: Optional[Dict[str, float]] = None
    elem_bytes: int = 2
    window_steps: List[Dict] = dataclasses.field(default_factory=list)
    window_s: Optional[float] = None

    @property
    def window(self):
        if not self.step_spans:
            return None
        return self.step_spans[0][0], self.step_spans[-1][1]


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------
def _args(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pick_device(chips: int, device: Optional[str]):
    """The first card, when there are ``chips`` of them; the CPU only when
    ``device="cpu"`` is asked for (the CPU tests)."""
    import torch
    if device == "cpu":
        from repro_torch import runtime
        runtime.set_device("cpu")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card and "
                      "never falls back to the CPU", 2)
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards and "
                      f"{torch.cuda.device_count()} are present", 2)
    return torch.device("cuda", 0)


def run(argv: List[str], root: Path, t0: float,
        device: Optional[str] = None) -> Dict:
    """One run; returns the result line's object."""
    args = _args(argv)
    cell = Cell.load(root, args.workload)
    dev = pick_device(cell.chips, device)
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['kind']}")
    out = driver.run(cell, dev, args.seed, args.seconds, bool(args.trace),
                     t0)
    on_card = dev.type == "cuda"
    metrics: Dict[str, Any] = {}
    if args.trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"])(out["reading"])
            if value is None:
                print(f"perfbench: {m['name']}: nothing to read",
                      file=sys.stderr)
                continue
            if m["source"] == "device_trace" and not on_card:
                value = NOT_MEASURED
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = out["end_to_end"].get(m["name"])
            if value is None:
                continue
            metrics[m["name"]] = {"value": value if on_card else NOT_MEASURED,
                                  "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": out["correct"], "attempted": out["attempted"],
        "failed": out["failed"], "metrics": metrics,
        "device": _device_info(dev, cell.chips, out, bool(args.trace))}
    if args.trace and on_card and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    # a number that came out infinite or NaN is printed as its name, so
    # that the line stays JSON
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                            else repr(v["value"]), "limit": v["limit"]}
                        for k, v in out["checks"].items()}
    return result


def _device_info(dev, chips: int, out: Dict, traced: bool) -> Dict:
    import torch
    if dev.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": NOT_MEASURED}
        if traced:
            info.update(busy_s=NOT_MEASURED, window_s=NOT_MEASURED)
        return info
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        info.update(busy_s=out["busy_s"], window_s=out["window_s"])
    return info


def report_checks(checks: Dict[str, Dict[str, float]]) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        value = c["value"]
        verdict = "ok" if (isinstance(value, float) and
                           value <= c["limit"]) else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)


def main(argv: List[str], t0: float, device: Optional[str] = None) -> int:
    root = Path(__file__).resolve().parents[1]
    try:
        result = run(argv, root, t0, device)
        # last, once every driver and metric reader has run: nothing runs
        # between this look and the result's line
        found = forbidden_modules()
        if found:
            raise Refused("modules of the JAX package or JAX itself are "
                          "loaded: " + ", ".join(found), 3)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    report_checks(result["checks"])
    return 0

