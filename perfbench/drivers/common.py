"""What the drivers share: the program's model with the benchmark's own
weights, the reference's weights, the profiler and the reading of its
trace, and the device's peak memory."""
from __future__ import annotations

import gc
import os
import sys
import tempfile
from typing import Dict, List, Tuple

from perfbench.harness import Reading
from perfbench.yardstick import flops, weights
from perfbench.yardstick.trace import Trace

#: the host span the drivers open around each traced step
STEP_SPAN = "perfbench.step"

_ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def program(cell, seed: int, dev):
    """(config, model, layout, parameters): the program's model of the
    cell with weights drawn from the seed in the layout of its ``meta``
    template."""
    from repro_torch.models import build
    cfg = cell.port_config()
    model = build(cfg)
    template = model.init(0, device="meta")
    spec = weights.layout(template)
    params = weights.rebuild(
        template, weights.draw(spec, cell.config["init"], seed, dev))
    return cfg, model, spec, params


def reference_weights(cell, spec, seed: int, dev):
    """The same values in float32, drawn again from the seed."""
    import torch
    drawn = weights.draw(spec, cell.config["init"], seed, dev)
    return {k: (v if v.dtype == torch.float32 else v.float())
            for k, v in drawn.items()}


def free_device() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def memory_peak(dev) -> int:
    import torch
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def step_span():
    import torch
    return torch.profiler.record_function(STEP_SPAN)


def read_trace(prof) -> Trace:
    """The profiler's trace, through its Chrome export in a temporary
    directory (under ``TMPDIR``), deleted once read."""
    with tempfile.TemporaryDirectory(prefix="perfbench-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return Trace.load(path)


def traced(cell, dev, prof, steps: List[Dict]) -> Tuple[Reading, Dict]:
    """The reading of the traced ``steps`` (the last ``len(steps)`` step
    spans of the trace) and the result's device fields: ``busy_s``,
    ``window_s`` and the ``breakdown``."""
    import torch
    trace = read_trace(prof)
    spans = trace.spans_named(STEP_SPAN)[-len(steps):]
    on_card = dev.type == "cuda"
    reading = Reading(
        model=cell.config["model"], steps=steps,
        trace=trace if on_card else None,
        step_spans=spans if len(spans) == len(steps) else None,
        peaks=flops.peak(torch.cuda.get_device_name(dev)) if on_card
        else None,
        elem_bytes=_ELEM_BYTES[cell.config["dtypes"]["compute"]])
    fields: Dict = {}
    window = reading.window
    if on_card and window is not None:
        lo, hi = window
        fields = {"busy_s": trace.busy_seconds(lo, hi), "window_s": hi - lo,
                  "breakdown": {"device_ops": trace.top_device_ops(lo, hi),
                                "idle_gaps": trace.idle_gaps(lo, hi)}}
        unmatched = sum(1 for _, _, _, c in trace.device_in(lo, hi)
                        if trace.launch_of(c) is None)
        print(f"perfbench: trace: {trace.kernel_count(lo, hi)} kernels in "
              f"{hi - lo:.3f} s, {unmatched} device operations with no "
              f"launch in the trace", file=sys.stderr)
    return reading, fields
