"""The reading of a ``torch.profiler`` trace (its Chrome JSON export).

Device activity is every kernel, memset and copy on the card.  Busy time
is the union of their intervals inside the traced window, not the sum of
their durations.  A kernel belongs to a host span (an op such as
``repro_torch::flash_attention_fwd``, or a ``record_function`` range such
as ``moe_ffn``) when the host call that launched it, matched by the
profiler's correlation id, lies inside that span on the same thread.
Times are in seconds.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CATS = ("cpu_op", "user_annotation")
#: how many earlier spans :meth:`Trace.innermost` looks back through
INNERMOST_WALK = 256

Interval = Tuple[float, float]


class Trace:
    """Device activity, launches and host spans of one trace."""

    def __init__(self, events: Iterable[dict]) -> None:
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launches: Dict[int, Tuple[float, object]] = {}
        self.spans: List[Tuple[float, float, str, object]] = []
        self.kernel_starts: List[float] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"]) * 1e-6
            end = ts + float(e.get("dur", 0.0)) * 1e-6
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, end, e.get("name", ""),
                                    args.get("correlation")))
                if cat == "kernel":
                    self.kernel_starts.append(ts)
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launches[int(args["correlation"])] = (ts, e.get("tid"))
            elif cat in SPAN_CATS:
                self.spans.append((ts, end, e.get("name", ""), e.get("tid")))
        self.device.sort()
        self.spans.sort()
        self._by_tid: Dict[object, List[Tuple[float, float, str]]] = \
            defaultdict(list)
        for ts, end, name, tid in self.spans:
            self._by_tid[tid].append((ts, end, name))
        self._starts = {tid: [s[0] for s in spans]
                        for tid, spans in self._by_tid.items()}
        # per (thread, name): starts and the running maximum of the ends,
        # so "is such a span open at t" is one bisection
        named: Dict[Tuple[object, str], List[Interval]] = defaultdict(list)
        for ts, end, name, tid in self.spans:
            named[(tid, name)].append((ts, end))
        self._named = {}
        for key, spans in named.items():
            reach, edge = [], float("-inf")
            for _, end in spans:
                edge = max(edge, end)
                reach.append(edge)
            self._named[key] = ([s for s, _ in spans], reach)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("traceEvents", []))

    def spans_named(self, name: str) -> List[Interval]:
        """The host spans called ``name``, in order."""
        return sorted((ts, end) for ts, end, sname, _ in self.spans
                      if sname == name)

    # ---- device time ----------------------------------------------------
    def device_in(self, lo: float, hi: float
                  ) -> List[Tuple[float, float, str, Optional[int]]]:
        """Device activity that overlaps [lo, hi]."""
        return [d for d in self.device if d[1] > lo and d[0] < hi]

    def busy_intervals(self, lo: float, hi: float) -> List[Interval]:
        """The union of device activity inside [lo, hi], as disjoint
        intervals."""
        merged: List[List[float]] = []
        for ts, end, _, _ in self.device_in(lo, hi):
            ts, end = max(ts, lo), min(end, hi)
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return [(a, b) for a, b in merged]

    def busy_seconds(self, lo: float, hi: float) -> float:
        return sum(b - a for a, b in self.busy_intervals(lo, hi))

    def kernel_count(self, lo: float, hi: float) -> int:
        """Kernels (not copies or memsets) that start inside [lo, hi]."""
        return sum(1 for ts in self.kernel_starts if lo <= ts < hi)

    def top_device_ops(self, lo: float, hi: float, n: int = 10
                       ) -> List[List]:
        """The ``n`` device operations (by name) that took most time."""
        total: Dict[str, float] = defaultdict(float)
        for ts, end, name, _ in self.device_in(lo, hi):
            total[name] += min(end, hi) - max(ts, lo)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, secs] for name, secs in ranked]

    # ---- host attribution -----------------------------------------------
    def launch_of(self, correlation: Optional[int]):
        if correlation is None:
            return None
        return self.launches.get(int(correlation))

    def innermost(self, tid, t: float) -> Optional[str]:
        """The innermost host span on thread ``tid`` open at time ``t``."""
        spans = self._by_tid.get(tid)
        if not spans:
            return None
        i = bisect.bisect_right(self._starts[tid], t) - 1
        for j in range(i, max(i - INNERMOST_WALK, -1), -1):
            ts, end, name = spans[j]
            if end >= t:
                return name
        return None

    def inside(self, tid, t: float, name: str) -> bool:
        """Whether a span called ``name`` on thread ``tid`` is open at
        ``t``."""
        found = self._named.get((tid, name))
        if not found:
            return False
        starts, reach = found
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and reach[i] >= t

    def under(self, name: str, lo: float, hi: float
              ) -> Tuple[float, int, int]:
        """(device seconds, device operations, unmatched operations) of
        the activity inside [lo, hi] whose launch lies in a span called
        ``name``.  An operation with no launch in the trace is counted as
        unmatched."""
        secs, count, unmatched = 0.0, 0, 0
        for ts, end, _, corr in self.device_in(lo, hi):
            launch = self.launch_of(corr)
            if launch is None:
                unmatched += 1
                continue
            if self.inside(launch[1], launch[0], name):
                secs += min(end, hi) - max(ts, lo)
                count += 1
        return secs, count, unmatched

    def span_count(self, name: str, lo: float, hi: float) -> int:
        """Host spans called ``name`` that start inside [lo, hi], a span
        nested in another of the same name on its thread not counted."""
        count, edge = 0, {}
        for ts, end, sname, tid in self.spans:
            if sname != name or not lo <= ts < hi:
                continue
            if ts < edge.get(tid, float("-inf")):
                continue
            count += 1
            edge[tid] = end
        return count

    def idle_gaps(self, lo: float, hi: float, n: int = 10) -> List[List]:
        """The idle time of [lo, hi] by what the host was doing: each gap
        between device activities is put to the innermost host span that
        launched the activity ending it (the window's tail to the span
        open on the step's thread at its end); the ``n`` largest sums."""
        busy = self.busy_intervals(lo, hi)
        starts = {}
        for ts, _, _, corr in self.device_in(lo, hi):
            starts.setdefault(max(ts, lo), corr)
        total: Dict[str, float] = defaultdict(float)
        edge = lo
        for a, b in busy:
            if a > edge:
                launch = self.launch_of(starts.get(a))
                name = (self.innermost(launch[1], launch[0])
                        if launch else None) or "(no launch in the trace)"
                total[name] += a - edge
            edge = b
        if hi > edge:
            total["(after the window's last device activity)"] += hi - edge
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, secs] for name, secs in ranked]

