"""The arithmetic behind the per-layer metric files of
``perfbench/metrics/``: each file names its quantity and calls one of
these on the run's :class:`perfbench.harness.Reading`.  Every function
returns None where the run gave it nothing to read: no trace of the
device, no peak for the card, or no work of its kind in the window.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from perfbench.yardstick import flops

K5_FWD_OP = "repro_torch::flash_attention_fwd"
K5_BWD_OP = "repro_torch::flash_attention_bwd"


def _window(r):
    if r.trace is None or r.window is None:
        return None
    return r.window


def launches_per_step(r) -> Optional[float]:
    """Kernels launched in the traced window, a step."""
    w = _window(r)
    if w is None or not r.steps:
        return None
    return r.trace.kernel_count(*w) / len(r.steps)


def idle_share(r) -> Optional[float]:
    """% of the untraced window in which no operation ran on the device:
    the traced steps' device time (the union of their kernels' intervals)
    a token, times the window's tokens, over the window's length.  The
    traced steps follow the window's mix, and their device time does not
    carry the profiler's host cost, which their spans do."""
    w = _window(r)
    if w is None or not r.window_s or not r.window_steps:
        return None
    traced = sum(s["tokens"] for s in r.steps)
    busy = sum(r.trace.busy_seconds(lo, hi) for lo, hi in r.step_spans)
    if traced == 0 or busy <= 0.0:
        return None
    window = sum(s["tokens"] for s in r.window_steps)
    return 100.0 * (1.0 - busy / traced * window / r.window_s)


def mfu(r, step_flops: Callable[[Dict, int, int], float]
        ) -> Optional[float]:
    """% of the bf16 peak: the model FLOPs of the untraced window's steps
    over its length on the host clock."""
    if r.peaks is None or not r.window_s or not r.window_steps:
        return None
    work = sum(step_flops(r.model, s["batch"], s["seq"])
               for s in r.window_steps)
    return 100.0 * work / (r.window_s * r.peaks["bf16_flops"])


def roofline(r, op: str, work: Callable[..., Dict[str, float]]
             ) -> Optional[float]:
    """% of K5's roofline: the least time of every call of ``op`` in the
    traced steps over the device time of the kernels they launched.  A
    step's calls take its batch and length (causal self-attention)."""
    w = _window(r)
    if w is None or r.peaks is None:
        return None
    m = flops.dims(r.model)
    least = 0.0
    for s, (lo, hi) in zip(r.steps, r.step_spans):
        calls = r.trace.span_count(op, lo, hi)
        one = work(s["batch"], m["heads"], m["kv_heads"], s["seq"], s["seq"],
                   m["head_dim"], r.elem_bytes)
        least += calls * flops.least_seconds(one, r.peaks)
    secs, count, _ = r.trace.under(op, *w)
    if count == 0 or secs <= 0.0:
        return None
    return 100.0 * least / secs


def span_us_per_token(r, span: str) -> Optional[float]:
    """Device microseconds of the kernels launched inside ``span``, per
    token of the traced steps."""
    w = _window(r)
    if w is None:
        return None
    secs, count, _ = r.trace.under(span, *w)
    tokens = sum(s["tokens"] for s in r.steps)
    if count == 0 or tokens == 0:
        return None
    return 1e6 * secs / tokens
