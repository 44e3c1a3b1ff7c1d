"""What-if design engine (paper §4) and workload-sweep questions.

The port's twin of the reference's ``core/whatif.py``.  Answers design
questions by re-costing a specification under a varied design /
hardware / workload, e.g.:

* "What if we change our hardware to HW3?"
* "Would it be beneficial to add a bloom filter in all B-tree leaves?"
* "What if the workload becomes skewed?"
* "How does the best design change as the read fraction goes 0 -> 1?"

A binary question is two cost-synthesis invocations (baseline +
variation) over the same inputs.  All kinds run on the batched/fused
engine (:mod:`repro_torch.core.batchcost` /
:mod:`repro_torch.core.devicecost`): design and workload questions pack
baseline and variant independently and *splice* them into one
two-design frontier, and a hardware question scores the *same* packed
frontier against both profiles — a pure device parameter-table swap with
zero re-synthesis and zero new kernel specialisations.

:func:`workload_sweep` generalizes the workload question to a whole
**design continuum**: a (designs x workloads) grid — read/write-ratio,
skew, selectivity or data-size axes — packed once by splicing shared
template statics with per-workload geometry columns and scored through
kernel K0 (:func:`repro_torch.core.batchcost.cost_sweep`).
``read_fraction_mixes`` builds the canonical read/write axis;
:func:`repro_torch.core.autocomplete.design_continuum` runs the sweep
over an auto-completion frontier.

Pass ``engine="scalar"`` to fall back to the per-record scalar path
(``cost_workload``) — the parity oracle.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batchcost import (SweepPoint, concat_frontiers,
                                  cost_sweep, normalize_points,
                                  pack_frontier)
from repro_torch.core.elements import DataStructureSpec
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.synthesis import Workload, cost_workload


def question_design(spec: DataStructureSpec,
                    variant: DataStructureSpec) -> str:
    return f"design {spec.describe()} -> {variant.describe()}"


def question_hardware(hw: HardwareProfile, new_hw: HardwareProfile) -> str:
    return f"hardware {hw.name} -> {new_hw.name}"


def question_workload(workload: Workload, new_workload: Workload) -> str:
    return (f"workload n={workload.n_entries},zipf={workload.zipf_alpha} -> "
            f"n={new_workload.n_entries},zipf={new_workload.zipf_alpha}")


@dataclasses.dataclass
class WhatIfAnswer:
    question: str
    baseline_seconds: float
    variant_seconds: float
    elapsed_seconds: float
    #: the scoring engine that produced the answer ("fused", "grouped",
    #: "scalar")
    engine: str = "fused"

    @property
    def speedup(self) -> float:
        return self.baseline_seconds / max(self.variant_seconds, 1e-30)

    @property
    def beneficial(self) -> bool:
        return self.variant_seconds < self.baseline_seconds

    def summary(self) -> str:
        verdict = "beneficial" if self.beneficial else "detrimental"
        return (f"{self.question}: {verdict} "
                f"({self.baseline_seconds:.3e}s -> {self.variant_seconds:.3e}s,"
                f" {self.speedup:.2f}x, answered in {self.elapsed_seconds:.2f}s)")


def what_if_design(spec: DataStructureSpec, variant: DataStructureSpec,
                   workload: Workload, hw: HardwareProfile,
                   mix: Optional[Dict[str, float]] = None,
                   engine: str = "fused") -> WhatIfAnswer:
    """Same workload + hardware, different design (Fig. 2 leftmost input).

    Baseline and variant pack independently (each a segment-cache hit
    when asked about before) and splice into one two-design frontier — a
    single fused scoring call answers the question.
    """
    t0 = time.perf_counter()
    if engine == "scalar":
        base = cost_workload(spec, workload, hw, mix)
        var = cost_workload(variant, workload, hw, mix)
    else:
        packed = concat_frontiers([pack_frontier([spec], workload, mix),
                                   pack_frontier([variant], workload, mix)])
        base, var = packed.score(hw, engine=engine)
    return WhatIfAnswer(question_design(spec, variant),
                        float(base), float(var), time.perf_counter() - t0,
                        engine=engine)


def what_if_hardware(spec: DataStructureSpec, workload: Workload,
                     hw: HardwareProfile, new_hw: HardwareProfile,
                     mix: Optional[Dict[str, float]] = None,
                     engine: str = "fused") -> WhatIfAnswer:
    """Test new hardware without deploying to it (paper §4/§5).

    The design is packed once; each profile only swaps its device
    parameter table into the already-compiled fused scorer.
    """
    t0 = time.perf_counter()
    if engine == "scalar":
        base = cost_workload(spec, workload, hw, mix)
        var = cost_workload(spec, workload, new_hw, mix)
    else:
        packed = pack_frontier([spec], workload, mix)
        base = packed.score(hw, engine=engine)[0]
        var = packed.score(new_hw, engine=engine)[0]
    return WhatIfAnswer(question_hardware(hw, new_hw),
                        float(base), float(var), time.perf_counter() - t0,
                        engine=engine)


def what_if_workload(spec: DataStructureSpec, workload: Workload,
                     new_workload: Workload, hw: HardwareProfile,
                     mix: Optional[Dict[str, float]] = None,
                     engine: str = "fused") -> WhatIfAnswer:
    """E.g. "what if queries skew to 0.01% of the key space?".

    Packing is workload-keyed but *scoring* is workload-free, so the two
    workload variants splice into one two-design frontier and a single
    fused call answers the question — and, like the design/hardware
    questions, repeat questions against either workload hit the segment
    cache instead of re-synthesizing the spec.
    """
    t0 = time.perf_counter()
    if engine == "scalar":
        base = cost_workload(spec, workload, hw, mix)
        var = cost_workload(spec, new_workload, hw, mix)
    else:
        packed = concat_frontiers([pack_frontier([spec], workload, mix),
                                   pack_frontier([spec], new_workload, mix)])
        base, var = packed.score(hw, engine=engine)
    return WhatIfAnswer(question_workload(workload, new_workload),
                        float(base), float(var), time.perf_counter() - t0,
                        engine=engine)


def question_sweep(points: Sequence[SweepPoint], n_designs: int) -> str:
    return f"sweep {len(points)} workloads x {n_designs} designs"


@dataclasses.dataclass
class WorkloadSweepAnswer:
    """The totals grid of a (designs x workloads) sweep.

    ``totals[w, d]`` is the cost of design ``d`` under sweep point ``w``
    — the full design continuum, answered in one fused scoring call.
    """

    question: str
    specs: Tuple[DataStructureSpec, ...]
    points: Tuple[SweepPoint, ...]
    totals: np.ndarray               # [n_points, n_designs]
    elapsed_seconds: float
    #: the scoring engine that produced the grid (see WhatIfAnswer.engine)
    engine: str = "fused"

    @property
    def best_indices(self) -> np.ndarray:
        """Index of the cheapest design per sweep point (computed once)."""
        cached = self.__dict__.get("_best_indices")
        if cached is None:
            cached = np.argmin(self.totals, axis=1)
            self.__dict__["_best_indices"] = cached
        return cached

    def best(self, point: int) -> Tuple[DataStructureSpec, float]:
        d = int(self.best_indices[point])
        return self.specs[d], float(self.totals[point, d])

    def continuum(self) -> List[Tuple[SweepPoint, DataStructureSpec,
                                      float]]:
        """(point, best design, cost) per sweep point — the
        best-design-vs-workload curve."""
        return [(p, *self.best(i)) for i, p in enumerate(self.points)]

    def summary(self) -> str:
        lines = [f"{self.question} in {self.elapsed_seconds:.2f}s"]
        for (workload, mix_items), spec, cost in self.continuum():
            mix = ", ".join(f"{op}={w:g}" for op, w in mix_items)
            lines.append(
                f"  zipf={workload.zipf_alpha:g} n={workload.n_entries}"
                f" [{mix}] -> {spec.describe()} ({cost:.3e}s)")
        return "\n".join(lines)


def read_fraction_mixes(fractions: Sequence[float],
                        n_ops: float = 100.0) -> List[Dict[str, float]]:
    """The canonical read/write-ratio axis: get/update mixes totalling
    ``n_ops`` operations per sweep point."""
    return [{"get": f * n_ops, "update": (1.0 - f) * n_ops}
            for f in fractions]


def workload_sweep(specs: Sequence[DataStructureSpec],
                   workloads: Sequence[Workload], hw: HardwareProfile,
                   mixes=None, engine: str = "fused"
                   ) -> WorkloadSweepAnswer:
    """Cost every design under every workload point, as one question.

    The generalization of :func:`what_if_workload` from one (baseline,
    variant) pair to a whole grid: template statics are packed once and
    every workload contributes only its numeric geometry columns, so a
    read/write-ratio or skew sweep is answered at frontier-scoring speed
    (one fused call) instead of one packing + scoring round per point.
    ``engine="scalar"`` is the per-cell ``cost_workload`` oracle.
    """
    t0 = time.perf_counter()
    specs = tuple(specs)
    points = normalize_points(workloads, mixes)
    if engine == "scalar":
        totals = np.asarray(
            [[cost_workload(s, w, hw, dict(mix_items)) for s in specs]
             for w, mix_items in points]).reshape(len(points), len(specs))
    else:
        totals = cost_sweep(specs, [p[0] for p in points], hw,
                            [dict(p[1]) for p in points], engine=engine)
    return WorkloadSweepAnswer(question_sweep(points, len(specs)), specs,
                               points, totals,
                               time.perf_counter() - t0, engine=engine)


def add_bloom_filters(spec: DataStructureSpec, num_hashes: int = 4,
                      num_bits: int = 1 << 14) -> DataStructureSpec:
    """The paper's running example: add a bloom filter to every leaf."""
    leaf = spec.terminal.with_values(
        bloom_filters=("on", num_hashes, num_bits),
        filters_memory_layout="scatter")
    return DataStructureSpec(spec.name + "+bloom",
                             spec.chain[:-1] + (leaf,))
