"""Design auto-completion (paper §4, Algorithm 1): enumeration and
completion.

The port's twin of the enumeration and completion half of the reference's
``core/autocomplete.py``.  ``complete_design`` fills in the missing suffix
of a partial element chain, ranking candidates by synthesized workload
cost.  The candidate frontier is enumerated up front (deduplicated by
element-name class — the paper's ``cachedSolution`` memoization) and
every surviving chain is costed in one
:func:`repro_torch.core.batchcost.cost_many` call — by default the fused
engine (kernel K0, :mod:`repro_torch.core.devicecost`);
``engine="grouped"`` selects the grouped oracle.  Pass ``batched=False``
to fall back to the scalar per-design path (same enumeration, same
argmin).

``design_continuum`` runs one auto-completion frontier against a whole
*workload axis* — a read/write-ratio or skew sweep — in a single
(designs x workloads) scoring call via
:func:`repro_torch.core.batchcost.cost_sweep`, returning the best design
per sweep point.

The local searches under a ``SearchBudget`` (hill climbing, beam search,
the neighborhood generator) and the hybrid Fig. 9 synthesis come with
the port of ``core/search.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import batchcost, elements as el
from repro_torch.core.batchcost import cost_many
from repro_torch.core.elements import DataStructureSpec, Element
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.synthesis import Workload, cost_workload


def default_candidates() -> List[Element]:
    """The element pool offered to the search (right side of Fig. 3)."""
    return [
        el.hash_element(100),
        el.range_element(100),
        el.btree_internal(20),
        el.csb_internal(20),
        el.linked_list_element(256),
        el.skip_list_element(256),
        el.trie_element(256, 4),
    ]


def default_terminals() -> List[Element]:
    return [el.unordered_data_page(256), el.ordered_data_page(256)]


@dataclasses.dataclass
class SearchResult:
    spec: DataStructureSpec
    cost_seconds: float
    explored: int
    elapsed_seconds: float
    #: the scoring engine that produced the costs
    engine: str = "fused"

    def summary(self) -> str:
        return (f"{self.spec.describe()}  cost={self.cost_seconds:.3e}s  "
                f"explored={self.explored} designs in "
                f"{self.elapsed_seconds:.2f}s")


def _meaningful(chain: Sequence[Element]) -> bool:
    """Prune meaningless paths (Algorithm 1 ``meaningfulPath``)."""
    seen_partitioners = 0
    for i, element in enumerate(chain[:-1] if chain and chain[-1].terminal
                                else chain):
        if element.tag("fanout") == "unlimited" and i > 0 and \
                chain[i - 1].tag("fanout") == "unlimited":
            return False  # LL of LL adds nothing
        if element.tag("key_partitioning") == "data-ind":
            seen_partitioners += 1
            if seen_partitioners > 2:
                return False
    return True


def _dedup_by_name(pool: Sequence[Element]) -> List[Element]:
    """Collapse duplicate pool entries (Algorithm 1's cachedSolution keys
    sub-searches by element-name class, so duplicates add no exploration)."""
    seen = set()
    out: List[Element] = []
    for e in pool:
        if e.name not in seen:
            seen.add(e.name)
            out.append(e)
    return out


def enumerate_completions(partial: Sequence[Element],
                          candidates: Sequence[Element],
                          terminals: Sequence[Element],
                          max_depth: int,
                          name: str = "auto") -> List[DataStructureSpec]:
    """All valid full chains reachable from ``partial``, in the depth-first
    order Algorithm 1 visits them (terminals first at each prefix, then
    each candidate extension in pool order) — the frontier to be costed."""
    candidates = _dedup_by_name(candidates)
    terminals = _dedup_by_name(terminals)
    frontier: List[DataStructureSpec] = []

    def extend(prefix: Tuple[Element, ...], depth: int) -> None:
        for term in terminals:
            chain = prefix + (term,)
            if not _meaningful(chain):
                continue
            try:
                frontier.append(DataStructureSpec(name, chain))
            except ValueError:
                continue
        if depth < max_depth:
            for cand in candidates:
                chain = prefix + (cand,)
                if not _meaningful(chain):
                    continue
                extend(chain, depth + 1)

    extend(tuple(partial), len(tuple(partial)))
    return frontier


@functools.lru_cache(maxsize=256)
def _enumerate_cached(partial: Tuple[Element, ...],
                      candidates: Tuple[Element, ...],
                      terminals: Tuple[Element, ...],
                      max_depth: int, name: str
                      ) -> Tuple[DataStructureSpec, ...]:
    """Enumeration is purely structural (no workload/hardware), so repeat
    searches over one pool reuse the frontier — in steady state the whole
    search pipeline is then cache-hit enumeration + cache-hit packing +
    one fused scoring call.  Registered with batchcost.clear_caches()."""
    return tuple(enumerate_completions(partial, candidates, terminals,
                                       max_depth, name))


batchcost.register_cache("enumerate", _enumerate_cached.cache_info,
                         _enumerate_cached.cache_clear)


def enumerate_frontier(partial: Sequence[Element],
                       candidates: Optional[Sequence[Element]] = None,
                       terminals: Optional[Sequence[Element]] = None,
                       max_depth: int = 3,
                       name: str = "auto") -> Tuple[DataStructureSpec, ...]:
    """The memoized candidate frontier of a completion question.

    Public entry point for callers that separate enumeration from scoring
    (a serving tier enumerates each request's frontier up front so a
    window of requests can splice into one fused scoring call).
    ``lru_cache`` keeps this thread-safe."""
    return _enumerate_cached(
        tuple(partial), tuple(candidates or default_candidates()),
        tuple(terminals or default_terminals()), max_depth, name)


def complete_design(partial: Sequence[Element], workload: Workload,
                    hw: HardwareProfile,
                    candidates: Optional[Sequence[Element]] = None,
                    terminals: Optional[Sequence[Element]] = None,
                    mix: Optional[Dict[str, float]] = None,
                    max_depth: int = 3,
                    name: str = "auto",
                    batched: bool = True,
                    engine: str = "fused") -> SearchResult:
    """Algorithm 1: complete a partial layout spec for (workload, hardware).

    ``partial`` is the known prefix of the element chain (may be empty).
    The search extends it with up to ``max_depth`` non-terminal candidates
    plus one terminal.  The whole frontier is costed in one batched call —
    fused by default, ``engine="grouped"`` for the grouped oracle
    (``batched=False`` re-costs it design-by-design through the scalar
    ``cost_workload`` path; all paths return the identical argmin design,
    to 1e-9 totals for grouped/scalar and 1e-6 for fused).
    """
    t0 = time.perf_counter()
    frontier = list(enumerate_frontier(partial, candidates, terminals,
                                       max_depth, name))
    if not frontier:
        raise RuntimeError("no valid completion found")
    if batched:
        totals = cost_many(frontier, workload, hw, mix, engine=engine)
    else:
        totals = np.asarray([cost_workload(spec, workload, hw, mix)
                             for spec in frontier])
    best = int(np.argmin(totals))  # first minimum — Algorithm 1's strict <
    return SearchResult(frontier[best], float(totals[best]), len(frontier),
                        time.perf_counter() - t0, engine=engine)


def complete_design_sweep(partial: Sequence[Element],
                          workloads: Sequence[Workload],
                          hw: HardwareProfile,
                          candidates: Optional[Sequence[Element]] = None,
                          terminals: Optional[Sequence[Element]] = None,
                          mixes=None,
                          max_depth: int = 3,
                          name: str = "auto",
                          engine: str = "fused") -> List[SearchResult]:
    """Algorithm 1 across a whole workload axis: one enumeration, one
    (designs x workloads) fused scoring call, one best design per point.

    The sweep twin of :func:`complete_design`: ``workloads`` (plus
    optional per-point ``mixes`` — see
    :func:`repro_torch.core.batchcost.normalize_points`) define the sweep
    axis; the returned list holds each point's winning design.  Each
    per-point result is identical to calling ``complete_design`` with
    that point's (workload, mix).
    """
    t0 = time.perf_counter()
    frontier = list(enumerate_frontier(partial, candidates, terminals,
                                       max_depth, name))
    if not frontier:
        raise RuntimeError("no valid completion found")
    grid = batchcost.cost_sweep(frontier, workloads, hw, mixes,
                                engine=engine)
    elapsed = time.perf_counter() - t0
    results = []
    for row in grid:
        best = int(np.argmin(row))   # first minimum — Algorithm 1's strict <
        results.append(SearchResult(frontier[best], float(row[best]),
                                    len(frontier), elapsed, engine=engine))
    return results


#: the paper-facing name: the best-design-vs-workload continuum curve
design_continuum = complete_design_sweep
