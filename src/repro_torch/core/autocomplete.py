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

The local searches (``design_hillclimb``, ``design_beam``) keep a
seen-set keyed on the cached element-chain hashes, so a chain costed in
an earlier round is never packed or scored again, and an optional
:class:`repro_torch.core.search.SearchBudget` caps the designs they cost
(shared with ``population_search``, so equal-budget comparisons are
exact).  ``design_hybrid`` reproduces the Fig. 9 scenarios: the workload
is split into domain regions with different read/write/range mixes and
each region's sub-design is auto-completed independently under a shared
partitioning root.
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
from repro_torch.core.search import BudgetExhausted, SearchBudget
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


# ---------------------------------------------------------------------------
# Greedy local search (hill climbing) over the design space
# ---------------------------------------------------------------------------
def design_neighbors(chain: Tuple[Element, ...],
                     candidates: Sequence[Element],
                     terminals: Sequence[Element]
                     ) -> List[DataStructureSpec]:
    """One-mutation neighborhood: fanout/capacity doublings and halvings,
    element swaps, terminal swaps, level drops.  Deterministic order."""
    neighbors = []
    for i, e in enumerate(chain):
        f = e.get("fanout")
        if isinstance(f, tuple) and f[0] == "fixed":
            for nf in (max(int(f[1]) // 2, 2), int(f[1]) * 2):
                if nf != f[1]:
                    neighbors.append(
                        chain[:i] + (e.with_values(fanout=("fixed", nf)),) +
                        chain[i + 1:])
        elif isinstance(f, tuple) and f[0] == "terminal":
            for nc in (max(int(f[1]) // 2, 16), min(int(f[1]) * 2, 1 << 16)):
                if nc != f[1]:
                    neighbors.append(
                        chain[:i] +
                        (e.with_values(fanout=("terminal", nc)),) +
                        chain[i + 1:])
    for i in range(len(chain) - 1):
        for cand in candidates:
            if cand.name != chain[i].name:
                neighbors.append(chain[:i] + (cand,) + chain[i + 1:])
        neighbors.append(chain[:i] + chain[i + 1:])  # drop level i
    for term in terminals:
        if term.name != chain[-1].name:
            neighbors.append(chain[:-1] + (term,))

    valid, seen = [], set()
    for nb in neighbors:
        key = tuple((e.name, e.get("fanout")) for e in nb)
        if key in seen or not _meaningful(nb):
            continue
        try:
            valid.append(DataStructureSpec("climb", nb))
        except ValueError:
            continue
        seen.add(key)
    return valid


def _cost_new_designs(frontier: Sequence[DataStructureSpec],
                      costs: Dict[Tuple[Element, ...], float],
                      workload: Workload, hw: HardwareProfile,
                      mix: Optional[Dict[str, float]], batched: bool,
                      engine: str,
                      budget: Optional[SearchBudget] = None) -> int:
    """Cost only the chains not in ``costs`` (one batched call) and fold
    them in; returns how many new designs were costed.  The seen-set is
    keyed on the cached ``Element`` chain hashes, so successive search
    rounds never re-pack or re-score a design costed earlier — and
    ``explored``/``designs_costed`` counts unique designs.  Deduped
    within the call too: beam rounds can reach one chain through several
    members' mutations.  A :class:`repro_torch.core.search.SearchBudget`
    truncates the batch to its remaining grant (budget accounting is
    designs-costed, shared with ``population_search`` so equal-budget
    comparisons are exact) — a zero grant folds in nothing."""
    new: List[DataStructureSpec] = []
    batch: set = set()
    for s in frontier:
        if s.chain not in costs and s.chain not in batch:
            batch.add(s.chain)
            new.append(s)
    if not new:
        return 0
    if budget is not None:
        try:
            new = new[:budget.charge(len(new))]
        except BudgetExhausted:
            return 0
        if not new:
            return 0
    if batched:
        totals = cost_many(new, workload, hw, mix, engine=engine)
    else:
        totals = [cost_workload(s, workload, hw, mix) for s in new]
    for s, total in zip(new, totals):
        costs[s.chain] = float(total)
    return len(new)


def design_hillclimb(workload: Workload, hw: HardwareProfile,
                     mix: Optional[Dict[str, float]] = None,
                     start: Optional[DataStructureSpec] = None,
                     max_steps: int = 30, batched: bool = True,
                     engine: str = "fused",
                     budget: Optional[SearchBudget] = None) -> Dict:
    """Greedy local search; each step packs and costs only the
    never-seen part of the neighbor frontier in one batched call (or a
    scalar loop with ``batched=False`` — the climb path and result are
    identical), reusing cached costs for neighbors revisited across
    rounds.  An optional :class:`repro_torch.core.search.SearchBudget` caps
    designs costed (the climb stops when the grant runs dry).  Returns
    a result dict."""
    candidates = default_candidates()
    terminals = default_terminals()
    spec = start or el.spec_btree()
    costs: Dict[Tuple[Element, ...], float] = {}
    t0 = time.perf_counter()
    _cost_new_designs([spec], costs, workload, hw, mix, batched, engine,
                      budget)
    if spec.chain not in costs:
        raise BudgetExhausted("budget too small to cost the start design")
    current = costs[spec.chain]
    for _ in range(max_steps):
        frontier = design_neighbors(spec.chain, candidates, terminals)
        if not frontier:
            break
        _cost_new_designs(frontier, costs, workload, hw, mix, batched,
                          engine, budget)
        totals = np.asarray([costs.get(s.chain, np.inf) for s in frontier])
        best = int(np.argmin(totals))
        # accept only improvements beyond the documented fused/scalar
        # agreement tolerance (1e-6 relative), so every costing path takes
        # the identical climb regardless of float-noise-level differences
        if totals[best] >= current * (1.0 - 1e-6):
            break
        spec, current = frontier[best], float(totals[best])
    elapsed = time.perf_counter() - t0
    return {"design": spec.describe(),
            "fanouts": [e.get("fanout") for e in spec.chain],
            "cost_s": current, "designs_costed": len(costs),
            "elapsed_s": elapsed,
            "designs_per_s": len(costs) / max(elapsed, 1e-12)}


def design_beam(workload: Workload, hw: HardwareProfile,
                mix: Optional[Dict[str, float]] = None,
                start: Optional[Sequence[DataStructureSpec]] = None,
                beam_width: int = 4, max_rounds: int = 12,
                batched: bool = True, engine: str = "fused",
                budget: Optional[SearchBudget] = None) -> Dict:
    """Beam search over the mutation neighborhood.

    Each round mutates every beam member and costs the union of
    never-seen neighbors in **one** batched call — the segment cache
    splices previously-packed designs, so round N+1 pays only for
    genuinely new chains (incremental frontier packing).  Stops when a
    round improves nothing, or when the optional
    :class:`repro_torch.core.search.SearchBudget` stops granting designs.
    Wider exploration than the greedy climb at the same per-round cost
    profile."""
    candidates = default_candidates()
    terminals = default_terminals()
    seeds = list(start) if start else [el.spec_btree()]
    costs: Dict[Tuple[Element, ...], float] = {}
    by_chain: Dict[Tuple[Element, ...], DataStructureSpec] = {}
    t0 = time.perf_counter()

    def admit(specs: Sequence[DataStructureSpec]) -> int:
        costed = _cost_new_designs(specs, costs, workload, hw, mix,
                                   batched, engine, budget)
        for s in specs:       # only scored chains compete for the beam
            if s.chain in costs:
                by_chain.setdefault(s.chain, s)
        return costed

    admit(seeds)
    beam = sorted(by_chain, key=lambda c: costs[c])[:beam_width]
    if not beam:
        raise BudgetExhausted("budget too small to cost any seed design")
    rounds = 0
    for _ in range(max_rounds):
        rounds += 1
        best_before = costs[beam[0]]
        neighbors: List[DataStructureSpec] = []
        for chain in beam:
            neighbors.extend(design_neighbors(chain, candidates, terminals))
        costed = admit(neighbors)
        beam = sorted(by_chain, key=lambda c: costs[c])[:beam_width]
        if costs[beam[0]] >= best_before * (1.0 - 1e-6) or \
                (budget is not None and costed == 0):
            break
    spec = by_chain[beam[0]]
    elapsed = time.perf_counter() - t0
    return {"design": spec.describe(),
            "fanouts": [e.get("fanout") for e in spec.chain],
            "cost_s": costs[beam[0]], "designs_costed": len(costs),
            "rounds": rounds, "elapsed_s": elapsed,
            "designs_per_s": len(costs) / max(elapsed, 1e-12)}


# ---------------------------------------------------------------------------
# Hybrid (Fig. 9) design synthesis
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DomainRegion:
    """A contiguous fraction of the key domain with its own operation mix."""

    name: str
    fraction: float                     # of the key domain
    mix: Dict[str, float]              # op -> count


@dataclasses.dataclass
class HybridDesign:
    root: Element
    regions: List[Tuple[DomainRegion, SearchResult]]
    cost_seconds: float
    elapsed_seconds: float

    def describe(self) -> str:
        parts = ", ".join(
            f"{region.name}: {result.spec.describe()}"
            for region, result in self.regions)
        return f"{self.root.name} -> {{{parts}}}"


def design_hybrid(workload: Workload, regions: Sequence[DomainRegion],
                  hw: HardwareProfile,
                  candidates: Optional[Sequence[Element]] = None,
                  root: Optional[Element] = None,
                  max_depth: int = 2,
                  batched: bool = True,
                  engine: str = "fused") -> HybridDesign:
    """Reproduce the paper's Fig. 9 search: per-region auto-completion under
    a shared partitioning root, costed on each region's own sub-workload.
    Each region's frontier is evaluated in one batched cost_many call."""
    t0 = time.perf_counter()
    root = root or el.hash_element(100)
    results: List[Tuple[DomainRegion, SearchResult]] = []
    total = 0.0
    for region in regions:
        sub_workload = dataclasses.replace(
            workload,
            n_entries=max(int(workload.n_entries * region.fraction), 1))
        result = complete_design((), sub_workload, hw,
                                 candidates=candidates, mix=region.mix,
                                 max_depth=max_depth,
                                 name=f"hybrid-{region.name}",
                                 batched=batched, engine=engine)
        results.append((region, result))
        total += result.cost_seconds
    # root routing cost: one probe per operation through the partitioner
    ops = sum(sum(r.mix.values()) for r in regions)
    from repro_torch.core import access
    from repro_torch.core.synthesis import CostBreakdown
    cb = CostBreakdown()
    fanout = root.fanout or 100
    cb.add(access.HASH_PROBE if
           root.get("key_partitioning", ("x",))[1] == "func" else
           access.RANDOM_ACCESS, fanout * 8, count=float(ops),
           note="root routing")
    total += cb.total(hw)
    return HybridDesign(root, results, total, time.perf_counter() - t0)
