"""The program's own phases in a traced run: device time and kernels
under its named spans, and the counts it tallies.

A kernel belongs to a phase when the host call that launched it lies
inside a span of that name on **any** thread.  On the card the autograd
engine launches a backward's kernels from its own device thread while
the step's thread waits inside ``train.backward``, so the same-thread
rule of :meth:`perfbench.yardstick.trace.Trace.under` would give that
span nothing.  Each function returns None where the run gave it nothing
to read: no trace of the device, no such span, or a program without
tallies.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def span_union(trace, names: Iterable[str]) -> List[Interval]:
    """The union of the host spans called one of ``names``, on every
    thread, as disjoint intervals in order."""
    names = set(names)
    merged: List[List[float]] = []
    for ts, end, _ in sorted((ts, end, n) for ts, end, n, _ in trace.spans
                             if n in names):
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([ts, end])
    return [(a, b) for a, b in merged]


def _inside(union: List[Interval], starts: List[float], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and union[i][1] >= t


def launched_under(trace, names: Iterable[str], lo: float, hi: float
                   ) -> Tuple[float, int]:
    """(device seconds, kernels) of the activity inside [lo, hi] whose
    launch lies in a span called one of ``names`` on any thread.  Seconds
    count every device operation, clipped to the window; kernels count
    the kernels (not copies or memsets) that start inside it."""
    union = span_union(trace, names)
    if not union:
        return 0.0, 0
    starts = [a for a, _ in union]
    kernel_starts = set(trace.kernel_starts)
    secs, kernels = 0.0, 0
    for ts, end, _, corr in trace.device_in(lo, hi):
        launch = trace.launch_of(corr)
        if launch is None or not _inside(union, starts, launch[0]):
            continue
        secs += min(end, hi) - max(ts, lo)
        if ts in kernel_starts and lo <= ts < hi:
            kernels += 1
    return secs, kernels


def _traced(r):
    if r.trace is None or r.window is None or not r.steps:
        return None
    return r.window


def phase_ms(r, name: str) -> Optional[float]:
    """Device milliseconds a traced step of the kernels launched under
    span ``name`` (any thread)."""
    w = _traced(r)
    if w is None:
        return None
    secs, kernels = launched_under(r.trace, [name], *w)
    if kernels == 0:
        return None
    return 1e3 * secs / len(r.steps)


def phase_launches(r, names: Iterable[str]) -> Optional[float]:
    """Kernels a traced step launched under spans called one of
    ``names`` (any thread)."""
    w = _traced(r)
    if w is None:
        return None
    _, kernels = launched_under(r.trace, names, *w)
    if kernels == 0:
        return None
    return kernels / len(r.steps)


def program_tallies() -> Optional[dict]:
    """The program's tallies (``repro_torch.tracing.tallies()``), which
    hold what ran under the profiler: the traced steps and whatever else
    the driver ran while it recorded (the prefill driver's warm batch);
    None for a program that keeps none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.tallies()


def moe_counts() -> Optional[Tuple[int, int]]:
    """(assigned, kept) of the MoE layers' tallies, or None where no MoE
    layer ran under the profiler."""
    t = program_tallies() or {}
    if not t.get("moe.assigned"):
        return None
    return t["moe.assigned"], t["moe.kept"]
