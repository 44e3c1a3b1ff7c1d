"""Operation and cost synthesis (paper §3, Fig. 5, Appendix E).

Given a data structure specification, a workload and a hardware profile,
the synthesizer:

1. simulates populating the structure (recursive block division) to obtain
   node counts / sizes / height — :class:`StructureInstance`;
2. walks the expert system per node, emitting a sequence of Level-1 access
   primitive invocations (the paper's abstract syntax tree), cache-aware:
   every random access carries the *path-so-far region size*, so nodes high
   in a hierarchy cost less than leaves (the §3 B-tree walk-through is
   reproduced verbatim by ``test_paper_btree_example``);
3. resolves Level-1 calls to Level-2 learned models and sums latencies.

Workload skew follows §3: node popularity p = count/total reweights the
region size of repeated accesses with w = 1/(p * sid).

This scalar expert system is the repo's **1e-9 oracle**.  The hot path —
packing whole search frontiers — runs through the template-vectorized
twin in :mod:`repro_torch.core.templatecost`: chains are grouped by *structural
template* (the per-level :func:`element_class` sequence plus the
terminal's emission flags) and this module emits each template's record
schema **once** (:func:`symbolic_breakdown`); templatecost then evaluates
all per-chain numeric sizes/counts as batched numpy column ops.  The
vectorized skew weights (:func:`skew_multipliers`) live here so the skew
model has a single home.  Record-level parity between the two paths is
asserted in ``tests/test_templatecost.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import access
from repro_torch.core.elements import DataStructureSpec, Element
from repro_torch.core.hardware import HardwareProfile

PTR_BYTES = 8
FENCE_BYTES = 8


@dataclasses.dataclass(frozen=True)
class Workload:
    """Data + query profile (paper's 'workload' input)."""

    n_entries: int
    n_queries: int = 100
    key_bytes: int = 8
    value_bytes: int = 8
    #: 0.0 = uniform; else Zipf alpha over the key space (Fig. 8b)
    zipf_alpha: float = 0.0
    #: range query selectivity (fraction of the key space per range op)
    selectivity: float = 0.001

    @property
    def pair_bytes(self) -> int:
        return self.key_bytes + self.value_bytes


@dataclasses.dataclass
class AccessRecord:
    """One Level-1 invocation: primitive(size) x count (weighted)."""

    level1: str
    level2: str
    size: float              # primitive-specific size argument (bytes or n)
    count: float = 1.0
    note: str = ""

    def cost(self, hw: HardwareProfile) -> float:
        return self.count * hw.model(self.level2).predict_scalar(self.size)


@dataclasses.dataclass
class CostBreakdown:
    records: List[AccessRecord] = dataclasses.field(default_factory=list)

    def add(self, level1: str, size: float, *, count: float = 1.0,
            layout: str = "columnar", op: str = "equal",
            note: str = "") -> None:
        level2 = access.resolve(level1, layout=layout, op=op)
        self.records.append(AccessRecord(level1, level2, max(size, 1.0),
                                         count, note))

    def extend(self, other: "CostBreakdown", scale: float = 1.0) -> None:
        for rec in other.records:
            self.records.append(dataclasses.replace(
                rec, count=rec.count * scale))

    def total(self, hw: HardwareProfile) -> float:
        return float(sum(rec.cost(hw) for rec in self.records))

    def format(self) -> str:
        """Paper Appendix G.1 style: P(782)+6P(200974)+5S(256)+..."""
        sym = {access.RANDOM_ACCESS: "P", access.SCAN: "S",
               access.SORTED_SEARCH: "B", access.HASH_PROBE: "H",
               access.BLOOM_PROBE: "F", access.SORT: "Q",
               access.SERIAL_WRITE: "W", access.ORDERED_BATCH_WRITE: "W",
               access.SCATTERED_BATCH_WRITE: "W",
               access.BATCHED_RANDOM_ACCESS: "P*"}
        parts = []
        for rec in self.records:
            prefix = "" if abs(rec.count - 1.0) < 1e-9 else \
                f"{rec.count:.3g}"
            parts.append(f"{prefix}{sym.get(rec.level1, '?')}({rec.size:.0f})")
        return "+".join(parts)


# ---------------------------------------------------------------------------
# Structure instantiation (recursive block division, §2 "blocks")
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LevelInfo:
    element: Element
    n_nodes: int                 # nodes at this level
    node_bytes: float            # bytes of one node (layout-aware)
    entries_per_node: float      # data entries routed through one node
    region_bytes: float = 0.0    # cache region: path-so-far (set later)


@dataclasses.dataclass
class StructureInstance:
    spec: DataStructureSpec
    workload: Workload
    levels: List[LevelInfo]

    @property
    def terminal(self) -> LevelInfo:
        return self.levels[-1]

    @property
    def total_bytes(self) -> float:
        return sum(l.n_nodes * l.node_bytes for l in self.levels)


def _node_bytes(element: Element, fanout: int, workload: Workload) -> float:
    """Bytes of one *internal* node given its layout primitives."""
    ptr = 0.0
    loc = element.tag("sub_block_physical_location")
    layout = element.tag("sub_block_physical_layout")
    if loc == "pointed":
        ptr = fanout * PTR_BYTES
    elif loc == "double-pointed":
        ptr = 2 * fanout * PTR_BYTES
    if layout in ("BFS", "BFS-layer") and loc != "inline":
        ptr = PTR_BYTES  # CSB+: children contiguous, one pointer suffices
    if loc == "inline" and layout in ("BFS", "BFS-layer"):
        ptr = 0.0        # FAST: offsets computed, pointers eliminated
    fences = 0.0
    zm = element.tag("zone_map_filters")
    if zm in ("min", "max", "exact"):
        fences = (fanout - 1) * FENCE_BYTES
    elif zm == "both":
        fences = 2 * (fanout - 1) * FENCE_BYTES
    bloom = 0.0
    bf = element.get("bloom_filters")
    if isinstance(bf, tuple) and bf[0] == "on":
        bloom = fanout * bf[2] / 8.0
    links = 0.0
    if element.tag("immediate_node_links") != "none":
        links += fanout * PTR_BYTES
    if element.tag("skip_node_links") != "none":
        links += fanout * PTR_BYTES  # one skip pointer per sub-block (perfect
        # links share the zone-map array, costed via filters)
    return ptr + fences + bloom + links


def instantiate(spec: DataStructureSpec, workload: Workload
                ) -> StructureInstance:
    """Simulate populating the structure: blocks -> node counts and sizes.

    Memoized on (element chain, workload): the chain is the structural
    fingerprint (the spec *name* does not affect population), so the four
    ``synthesize_*`` operations and every candidate in a batched design
    search share one simulation instead of re-running it per call.  A new
    workload is a new key — the cache invalidates by construction.  The
    returned LevelInfos are copies: callers may tweak them (what-if
    experiments) without poisoning the cache.
    """
    levels = _instantiate_levels(spec.chain, workload)
    return StructureInstance(spec, workload,
                             [dataclasses.replace(l) for l in levels])


def clear_synthesis_caches() -> None:
    """Drop the instantiate / skew-weight / schema memos (tests, profile
    reloads)."""
    _instantiate_levels.cache_clear()
    _zipf_collision_mass.cache_clear()
    symbolic_breakdown.cache_clear()


@functools.lru_cache(maxsize=8192)
def _instantiate_levels(chain: Tuple[Element, ...], workload: Workload
                        ) -> Tuple[LevelInfo, ...]:
    spec = DataStructureSpec("instantiate", chain)
    levels: List[LevelInfo] = []
    n = max(workload.n_entries, 1)
    terminal = spec.terminal
    capacity = terminal.capacity or 256
    n_leaves = max(math.ceil(n / capacity), 1)

    # walk non-terminal chain, dividing blocks
    blocks = 1              # logical blocks at the current frontier
    entries = float(n)
    for element in spec.chain[:-1]:
        fanout = element.fanout
        if fanout is None and element.tag("fanout") == "unlimited":
            # linked-list style: sub-blocks are the terminal pages themselves;
            # the element is a "without data" model (paper §2) — one header
            levels.append(LevelInfo(element, blocks, PTR_BYTES * 2,
                                    entries / max(blocks, 1)))
            continue
        fanout = fanout or 2
        recursion = element.tag("recursion")
        if recursion == "yes":
            # recurse until blocks of terminal capacity (B+tree / trie)
            depth = 0
            rec_arg = element.get("recursion")
            max_depth = rec_arg[1] if isinstance(rec_arg, tuple) and \
                isinstance(rec_arg[1], int) else 64
            while blocks * fanout < n_leaves and depth < max_depth - 1:
                levels.append(LevelInfo(
                    element, blocks, _node_bytes(element, fanout, workload),
                    entries / blocks if blocks else entries))
                blocks *= fanout
                depth += 1
            levels.append(LevelInfo(
                element, blocks, _node_bytes(element, fanout, workload),
                entries / blocks))
            blocks *= fanout
        else:
            levels.append(LevelInfo(
                element, blocks, _node_bytes(element, fanout, workload),
                entries / blocks))
            blocks *= fanout

    # terminal level
    n_term = max(n_leaves, blocks if spec.chain[:-1] and
                 spec.chain[-2].tag("fanout") != "unlimited" else n_leaves)
    # partitioned structures keep at least one page per partition
    term_bytes = min(capacity, n / max(n_term, 1)) * workload.pair_bytes
    levels.append(LevelInfo(terminal, int(n_term),
                            max(term_bytes, workload.pair_bytes),
                            entries / max(n_term, 1)))

    # cache regions: cumulative path-so-far (paper §3 example)
    cumulative = 0.0
    for level in levels:
        cumulative += level.n_nodes * level.node_bytes
        level.region_bytes = cumulative
        layout = level.element.tag("sub_block_physical_layout")
        if layout in ("BFS", "BFS-layer"):
            # cache-conscious: children contiguous with the parent — the
            # random access resolves within the parent's child group
            fanout = level.element.fanout or 2
            group = fanout * level.node_bytes
            level.region_bytes = min(cumulative, max(group, level.node_bytes))
    return tuple(levels)


# ---------------------------------------------------------------------------
# Skew (paper §3 "Workload Skew and Caching Effects")
# ---------------------------------------------------------------------------
def _skew_region_multiplier(popularity: float, n_queries: int) -> float:
    """E_sid[min(1, 1/(p * sid))] — averaged weight w = 1/(p*sid) over the
    workload, clamped to 1 (a cold first access costs the full region)."""
    if popularity <= 0.0 or n_queries <= 1:
        return 1.0
    s0 = min(max(1.0 / popularity, 1.0), n_queries)
    # sum_{sid<=s0} 1 + sum_{sid>s0} 1/(p*sid)  ~ s0 + (ln S - ln s0)/p
    total = s0 + (math.log(n_queries) - math.log(s0)) / popularity
    return min(total / n_queries, 1.0)


def _zipf_top_mass(alpha: float, n_items: int, rank: int = 1) -> float:
    """Probability mass of the rank-th most popular item under Zipf(alpha)."""
    if alpha <= 0.0 or n_items <= 1:
        return 1.0 / max(n_items, 1)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    return float(weights[rank - 1] / weights.sum())


@functools.lru_cache(maxsize=4096)
def _zipf_collision_mass(n_items: int, alpha: float) -> float:
    """sum_r mass_r^2 under Zipf(alpha) — memoized: a design search asks for
    the same (n_nodes, alpha) pair for every candidate sharing a level
    geometry, and the 4096-element weight array is costly to rebuild."""
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    weights /= weights.sum()
    return float((weights ** 2).sum())


def _level_popularity(level: LevelInfo, workload: Workload) -> float:
    """Expected popularity of the node a query visits at this level."""
    n = max(level.n_nodes, 1)
    if workload.zipf_alpha <= 0.0:
        return 1.0 / n
    # under skew a query visits the popular node with its zipf mass; use the
    # mean mass of the visited node = sum_r mass_r^2 (collision probability)
    return _zipf_collision_mass(min(n, 4096), workload.zipf_alpha)


def skew_multipliers(n_nodes: np.ndarray, workload: Workload) -> np.ndarray:
    """Vectorized twin of ``_skew_region_multiplier(_level_popularity(..))``.

    Takes the per-record node counts of the levels being accessed and
    returns the §3 skew region multipliers as one array — the zipf
    collision masses are served from the same ``_zipf_collision_mass``
    memo the scalar path uses, so the two paths share one weight table.
    Matches the scalar composition to float tolerance (same op sequence;
    ``np.log`` vs ``math.log`` differ by at most ~1 ulp).
    """
    n_nodes = np.asarray(n_nodes, dtype=np.float64)
    if workload.zipf_alpha <= 0.0 or workload.n_queries <= 1 or \
            len(n_nodes) == 0:
        return np.ones(len(n_nodes))
    n = np.minimum(np.maximum(n_nodes, 1.0), 4096.0).astype(np.int64)
    uniq, inv = np.unique(n, return_inverse=True)
    masses = np.asarray([_zipf_collision_mass(int(u), workload.zipf_alpha)
                         for u in uniq])
    p = masses[inv]
    s = workload.n_queries
    s0 = np.minimum(np.maximum(1.0 / p, 1.0), float(s))
    total = s0 + (math.log(s) - np.log(s0)) / p
    return np.minimum(total / s, 1.0)


def _random_access(cb: CostBreakdown, level: LevelInfo, workload: Workload,
                   note: str) -> None:
    # Skew reweighting (§3) applies only to skewed workloads; the uniform
    # case logs the raw path-so-far region, matching the paper's example.
    mult = 1.0
    if workload.zipf_alpha > 0.0:
        mult = _skew_region_multiplier(_level_popularity(level, workload),
                                       workload.n_queries)
    cb.add(access.RANDOM_ACCESS, level.region_bytes * mult, note=note)


# ---------------------------------------------------------------------------
# Get synthesis (Fig. 5 / Appendix E expert system)
# ---------------------------------------------------------------------------
def synthesize_get(spec: DataStructureSpec, workload: Workload
                   ) -> CostBreakdown:
    cb = CostBreakdown()
    inst = instantiate(spec, workload)
    for level in inst.levels[:-1]:
        el = level.element
        part = el.tag("key_partitioning")
        fanout = el.fanout
        if el.tag("fanout") == "unlimited":
            # linked-list navigation: expected half the sibling pages visited
            if el.tag("skip_node_links") == "perfect":
                # skip-list: binary-search-style navigation over page minima
                # (the terminal step below adds the target-page probe)
                cb.add(access.SORTED_SEARCH,
                       max(level.entries_per_node /
                           (inst.terminal.element.capacity or 256), 1.0) *
                       FENCE_BYTES, note="skip links")
                continue
            pages = max(level.entries_per_node /
                        (inst.terminal.element.capacity or 256), 1.0)
            visited = (pages + 1) / 2.0
            _random_access(cb, inst.terminal, workload, "ll head")
            if visited > 1:
                cb.records.append(AccessRecord(
                    access.RANDOM_ACCESS,
                    access.resolve(access.RANDOM_ACCESS),
                    inst.terminal.region_bytes, visited - 1, "ll page hops"))
                # full scans of the pages before the hit
                cap = inst.terminal.element.capacity or 256
                cb.records.append(AccessRecord(
                    access.SCAN, access.resolve(access.SCAN),
                    cap * workload.key_bytes, visited - 1, "ll page scans"))
            continue
        if part == "data-ind":
            kind = el.get("key_partitioning")
            _random_access(cb, level, workload, f"{el.name} node")
            if kind[1] == "func":        # hash partitioning
                cb.add(access.HASH_PROBE, level.n_nodes * (fanout or 1) *
                       PTR_BYTES, note="hash bucket probe")
            # range/radix partitioning: offset computation, no extra probe
            continue
        if part == "data-dep":
            # sorted fences: random access to node + sorted search over fences
            _random_access(cb, level, workload, f"{el.name} node")
            fences = max((fanout or 2) - 1, 1)
            layout = "row-wise"  # fences+pointers paired within the node
            cb.add(access.SORTED_SEARCH, fences * FENCE_BYTES,
                   layout=layout, note=f"{el.name} fences")
            if el.tag("bloom_filters") == "on":
                bf = el.get("bloom_filters")
                cb.add(access.BLOOM_PROBE, bf[2] / 8.0, note="bloom")
            continue
        # append/temporal partitioning at internal level: scan sub-blocks
        _random_access(cb, level, workload, f"{el.name} node")
        cb.add(access.SCAN, (fanout or 2) * FENCE_BYTES, note="append scan")

    # terminal node
    term = inst.terminal
    el = term.element
    entries = max(term.entries_per_node, 1.0)
    _random_access(cb, term, workload, "leaf")
    if el.tag("bloom_filters") == "on":
        bf = el.get("bloom_filters")
        cb.add(access.BLOOM_PROBE, bf[2] / 8.0, note="leaf bloom")
    layout = el.tag("key_value_layout")
    if el.sorted_keys:
        cb.add(access.SORTED_SEARCH, entries * workload.key_bytes,
               layout=layout, note="leaf search")
    else:
        # expected half scan on a hit
        cb.records.append(AccessRecord(
            access.SCAN, access.resolve(access.SCAN, layout=layout),
            entries * workload.key_bytes / 2, 1.0, "leaf scan"))
    if layout != "row-wise" and el.retains_values:
        cb.add(access.RANDOM_ACCESS, entries * workload.value_bytes,
               note="value fetch")
    return cb


def synthesize_range_get(spec: DataStructureSpec, workload: Workload
                         ) -> CostBreakdown:
    """Fig. 10: descend to the low key, then sweep qualifying leaves."""
    cb = synthesize_get(spec, workload)  # locate the first qualifying leaf
    inst = instantiate(spec, workload)
    term = inst.terminal
    frac = max(workload.selectivity, 0.0)
    n_pages = max(math.ceil(frac * term.n_nodes), 1)
    el = term.element
    layout = el.tag("key_value_layout")
    cap = max(term.entries_per_node, 1.0)
    if el.tag("area_links") != "none" or term.n_nodes == 1:
        hop_region = term.region_bytes
    else:
        # re-descend through the parent for each page (no leaf links)
        hop_region = inst.total_bytes
    if n_pages > 1:
        cb.records.append(AccessRecord(
            access.RANDOM_ACCESS, access.resolve(access.RANDOM_ACCESS),
            hop_region, n_pages - 1, "range page hops"))
    cb.records.append(AccessRecord(
        access.SCAN, access.resolve(access.SCAN, layout=layout, op="range"),
        cap * workload.key_bytes, float(n_pages), "range scans"))
    return cb


def synthesize_bulk_load(spec: DataStructureSpec, workload: Workload
                         ) -> CostBreakdown:
    """Fig. 10: optional sort, then partition + write per level."""
    cb = CostBreakdown()
    inst = instantiate(spec, workload)
    n = workload.n_entries
    data_bytes = n * workload.pair_bytes
    if inst.terminal.element.sorted_keys:
        cb.add(access.SORT, n, note="sort input")
        cb.add(access.ORDERED_BATCH_WRITE, data_bytes, note="write leaves")
    else:
        cb.add(access.SERIAL_WRITE, data_bytes, note="write pages")
    for level in inst.levels[:-1]:
        el = level.element
        part = el.tag("key_partitioning")
        level_bytes = level.n_nodes * level.node_bytes
        if part == "data-ind":
            # one partitioning pass over the data + scattered writes
            cb.add(access.SCAN, data_bytes, note="partition pass")
            cb.add(access.SCATTERED_BATCH_WRITE, max(level_bytes, 1.0),
                   note=f"write {el.name} level")
        else:
            cb.add(access.ORDERED_BATCH_WRITE, max(level_bytes, 1.0),
                   note=f"write {el.name} level")
    return cb


def synthesize_update(spec: DataStructureSpec, workload: Workload
                      ) -> CostBreakdown:
    """Paper §5: value update = point query + one write access."""
    cb = synthesize_get(spec, workload)
    inst = instantiate(spec, workload)
    cb.add(access.SERIAL_WRITE, workload.value_bytes, note="write value")
    return cb


OPERATIONS = {
    "get": synthesize_get,
    "range_get": synthesize_range_get,
    "bulk_load": synthesize_bulk_load,
    "update": synthesize_update,
}


# ---------------------------------------------------------------------------
# Structural templates: the symbolic form of the expert system above.
# ---------------------------------------------------------------------------
#: emission classes — which record sequence an internal level contributes
#: to a synthesized operation (the per-level coordinate of a chain's
#: structural template; see repro_torch.core.templatecost)
(CLS_SKIP, CLS_LL, CLS_IND_FUNC, CLS_IND, CLS_DEP, CLS_APPEND,
 CLS_DEP_BLOOM) = range(7)


def element_class(element: Element) -> int:
    """The emission class of one element — the branch the ``synthesize_*``
    walkers take for its levels, as data."""
    if element.tag("fanout") == "unlimited":
        return CLS_SKIP if element.tag("skip_node_links") == "perfect" \
            else CLS_LL
    part = element.tag("key_partitioning")
    if part == "data-ind":
        return CLS_IND_FUNC if element.get("key_partitioning")[1] == "func" \
            else CLS_IND
    if part == "data-dep":
        return CLS_DEP_BLOOM if element.tag("bloom_filters") == "on" \
            else CLS_DEP
    return CLS_APPEND


@functools.lru_cache(maxsize=4096)
def symbolic_breakdown(op: str, template: Tuple
                       ) -> Tuple[Tuple[str, str], ...]:
    """One operation's record schema for a structural template.

    ``template`` is ``(per-level class tuple, (sorted, bloom, layout,
    value_fetch, area_links))`` as produced by
    :func:`repro_torch.core.templatecost.chain_geometry`.  The schema — the
    ordered (Level-1, Level-2) pairs the expert system emits — is
    synthesized **once per template**; every chain sharing the template
    shares this layout, and :mod:`repro_torch.core.templatecost` evaluates the
    per-chain numeric sizes/counts as batched array ops (slots the scalar
    walker would skip, e.g. linked-list page hops when a single page is
    visited, carry count 0).
    """
    classes, (sorted_, bloom, layout, value_fetch, _area) = template
    p_rec = (access.RANDOM_ACCESS, access.resolve(access.RANDOM_ACCESS))
    recs: List[Tuple[str, str]] = []
    if op in ("get", "range_get", "update"):
        for cls in classes:
            if cls == CLS_SKIP:
                recs.append((access.SORTED_SEARCH,
                             access.resolve(access.SORTED_SEARCH)))
            elif cls == CLS_LL:
                recs += [p_rec, p_rec,
                         (access.SCAN, access.resolve(access.SCAN))]
            elif cls == CLS_IND_FUNC:
                recs += [p_rec, (access.HASH_PROBE,
                                 access.resolve(access.HASH_PROBE))]
            elif cls == CLS_IND:
                recs.append(p_rec)
            elif cls in (CLS_DEP, CLS_DEP_BLOOM):
                recs += [p_rec, (access.SORTED_SEARCH, access.resolve(
                    access.SORTED_SEARCH, layout="row-wise"))]
                if cls == CLS_DEP_BLOOM:
                    recs.append((access.BLOOM_PROBE,
                                 access.resolve(access.BLOOM_PROBE)))
            else:
                recs += [p_rec, (access.SCAN, access.resolve(access.SCAN))]
        recs.append(p_rec)                       # leaf descent
        if bloom:
            recs.append((access.BLOOM_PROBE,
                         access.resolve(access.BLOOM_PROBE)))
        if sorted_:
            recs.append((access.SORTED_SEARCH,
                         access.resolve(access.SORTED_SEARCH,
                                        layout=layout)))
        else:
            recs.append((access.SCAN, access.resolve(access.SCAN,
                                                     layout=layout)))
        if value_fetch:
            recs.append(p_rec)
        if op == "range_get":
            recs += [p_rec, (access.SCAN, access.resolve(
                access.SCAN, layout=layout, op="range"))]
        elif op == "update":
            recs.append((access.SERIAL_WRITE,
                         access.resolve(access.SERIAL_WRITE)))
    elif op == "bulk_load":
        if sorted_:
            recs += [(access.SORT, access.resolve(access.SORT)),
                     (access.ORDERED_BATCH_WRITE,
                      access.resolve(access.ORDERED_BATCH_WRITE))]
        else:
            recs.append((access.SERIAL_WRITE,
                         access.resolve(access.SERIAL_WRITE)))
        for cls in classes:
            if cls in (CLS_IND, CLS_IND_FUNC):
                recs += [(access.SCAN, access.resolve(access.SCAN)),
                         (access.SCATTERED_BATCH_WRITE,
                          access.resolve(access.SCATTERED_BATCH_WRITE))]
            else:
                recs.append((access.ORDERED_BATCH_WRITE,
                             access.resolve(access.ORDERED_BATCH_WRITE)))
    else:
        raise KeyError(op)
    return tuple(recs)


def synthesize_operation(op: str, spec: DataStructureSpec,
                         workload: Workload) -> CostBreakdown:
    return OPERATIONS[op](spec, workload)


def cost(op: str, spec: DataStructureSpec, workload: Workload,
         hw: HardwareProfile) -> float:
    """Latency (seconds) of one operation — the Calculator's main output."""
    return synthesize_operation(op, spec, workload).total(hw)


def cost_workload(spec: DataStructureSpec, workload: Workload,
                  hw: HardwareProfile,
                  mix: Optional[Dict[str, float]] = None) -> float:
    """Sets of operations in a single pass (§3): weighted operation mix."""
    mix = mix or {"get": float(workload.n_queries)}
    total = 0.0
    for op, count in mix.items():
        total += count * cost(op, spec, workload, hw)
    return total
