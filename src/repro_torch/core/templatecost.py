"""Template-vectorized cost synthesis: pack whole frontiers without
per-design Python, and without per-*workload* re-derivation.

The port's copy of the reference packer (numpy only; it never touches the
device).  A packed segment splits into two orthogonal parts:

* **Template statics** (:func:`chain_statics`, memoized on
  ``(chain, depth signature)`` — *no workload anywhere in the key*): the
  per-element resolution (:class:`ElementStatics`), the expanded level
  structure, internal node bytes and cache regions, the structural
  template, and — via the ``segment_statics`` interning cache keyed
  ``(template, ops)`` — each segment's record model-ids and layout.
  The *depth signature* (:func:`_expansion_depths`) is the tuple of
  expanded level counts; every workload that lands on the same structure
  shares one entry.
* **Workload geometry columns** (:func:`_build_workload_cols`): the
  workload-dependent numerics evaluated as batched column ops over a
  **workload axis**: one ``[n_workloads, records]`` numpy expression per
  emission class covers every (chain, workload) cell of a sweep.

The pipeline is then:

1. **Geometry**: resolve statics per chain, build one flat SoA level table
   for all chains (:func:`_build_tables`), and evaluate the workload
   columns for all sweep points at once.
2. **Flat emission** (:func:`emit_operation`): every operation's records
   are emitted as ``[W, records]`` column ops over *emission-class
   masks*.  Records a chain's scalar synthesis would *not* emit carry
   count 0.
3. **Assembly** (:func:`pack_points`): one argsort orders records by
   (chain, op, level, slot) and a vectorized scatter pads each design's
   block to a ``devicecost.TILE`` multiple.  The per-chain model-id
   arrays are interned on ``(template, ops)``.

:func:`pack_specs` is the single-workload wrapper
(``pack_points(chains, one point)``) used by
:mod:`repro_torch.core.batchcost`.

The scalar path in :mod:`repro_torch.core.synthesis` stays the 1e-9
oracle.  Hardware never enters any key or value here — packing a frontier
once serves every what-if-hardware question unchanged.  Workload never
enters a *statics* key — sweeping workloads re-derives only the numeric
columns.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import access
from repro_torch.core.devicecost import TILE, model_id
from repro_torch.core.elements import Element
from repro_torch.core import memo
from repro_torch.core.memo import MEMO_LOCK, DictCache
from repro_torch.core.synthesis import (CLS_APPEND, CLS_DEP, CLS_DEP_BLOOM,
                                  CLS_IND, CLS_IND_FUNC, CLS_LL, CLS_SKIP,
                                  FENCE_BYTES, PTR_BYTES, Workload,
                                  _node_bytes, element_class,
                                  skew_multipliers, symbolic_breakdown)

#: slots reserved per level in the intra-chain record order key
_SLOTS = 16
#: order-key stride per operation of the mix
_OP_STRIDE = 1 << 12


@functools.lru_cache(maxsize=64)
def _mid(level1: str, layout: str = "columnar", op: str = "equal") -> int:
    """Interned Level-2 model id of a resolved Level-1 call (lazy, so the
    global interning order stays exactly what the scalar path produces)."""
    return model_id(access.resolve(level1, layout=layout, op=op))


@dataclasses.dataclass(frozen=True)
class ElementStatics:
    """Everything synthesis ever reads from one element, resolved once.

    Purely structural — no workload, no hardware.  ``node_bytes`` is
    workload-independent (``synthesis._node_bytes`` never reads its
    workload argument; the record-parity tests run the same statics
    against several workloads and would catch a drift).
    """

    terminal: bool
    unlimited: bool
    fanout: Optional[int]          # fixed fanout value (None otherwise)
    capacity: Optional[int]        # terminal capacity (None otherwise)
    recursive: bool
    max_depth: int
    node_bytes: float              # internal node bytes (unlimited: header)
    bfs: bool                      # BFS / BFS-layer cache-region adjustment
    cls: int                       # emission class (see synthesis.CLS_*)
    fences: float                  # max(fanout - 1, 1) for data-dep search
    bloom_bits: float              # 0.0 when bloom_filters is off
    sorted_keys: bool
    layout: str                    # key_value_layout tag
    value_fetch: bool              # non-row-wise leaf refetches values
    area_links: bool               # leaf-to-leaf links (range sweeps)


def _compute_statics(e: Element) -> ElementStatics:
    unlimited = e.tag("fanout") == "unlimited"
    fanout = e.fanout
    rec_arg = e.get("recursion")
    max_depth = rec_arg[1] if isinstance(rec_arg, tuple) and \
        isinstance(rec_arg[1], int) else 64
    bf = e.get("bloom_filters")
    bloom_bits = float(bf[2]) if isinstance(bf, tuple) and bf[0] == "on" \
        else 0.0
    layout = e.tag("key_value_layout")
    if e.terminal or unlimited:
        node_bytes = 2.0 * PTR_BYTES   # terminal unused; LL page header
    else:
        # _node_bytes is workload-independent (asserted by parity tests)
        node_bytes = _node_bytes(e, fanout or 2, None)
    return ElementStatics(
        terminal=e.terminal, unlimited=unlimited, fanout=fanout,
        capacity=e.capacity, recursive=e.tag("recursion") == "yes",
        max_depth=max_depth, node_bytes=node_bytes,
        bfs=e.tag("sub_block_physical_layout") in ("BFS", "BFS-layer"),
        cls=element_class(e), fences=float(max((fanout or 2) - 1, 1)),
        bloom_bits=bloom_bits, sorted_keys=e.sorted_keys, layout=layout,
        value_fetch=layout != "row-wise" and e.retains_values,
        area_links=e.tag("area_links") != "none")


#: equal elements share one statics record; instances additionally pin it
#: on ``Element._tc_statics`` so the geometry pass pays one attribute read
_STATICS_BY_VALUE: Dict[Tuple, ElementStatics] = {}


def statics_of(e: Element) -> ElementStatics:
    st = e._tc_statics
    if st is None:
        # under the shared memo lock so a concurrent clear_template_caches
        # cannot interleave with the by-value insert (duplicate statics
        # would be benign, a torn OrderedDict/counter state would not be)
        with MEMO_LOCK:
            st = _STATICS_BY_VALUE.get(e.values)
            if st is None:
                st = _compute_statics(e)
                _STATICS_BY_VALUE[e.values] = st
        object.__setattr__(e, "_tc_statics", st)
    return st


# ---------------------------------------------------------------------------
# Template statics — the workload-free half of a chain's geometry
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=65536)
def _expansion_depths(chain: Tuple[Element, ...], n_entries: int
                      ) -> Tuple[int, ...]:
    """Per-element expanded level counts — the chain's *depth signature*.

    The only thing ``n_entries`` decides about a chain's structure is how
    many levels each recursive element expands to; everything else (node
    counts, bytes, regions) follows from the signature alone.  This is a
    trivial integer loop; the expensive statics are keyed on the
    signature, so every workload landing on the same structure shares
    one :class:`ChainStatics`.
    """
    term_st = statics_of(chain[-1])
    n = max(n_entries, 1)
    capacity = term_st.capacity or 256
    n_leaves = max(math.ceil(n / capacity), 1)
    depths: List[int] = []
    blocks = 1
    for element in chain[:-1]:
        st = statics_of(element)
        if st.fanout is None and st.unlimited:
            depths.append(1)
            continue
        fanout = st.fanout or 2
        d = 1
        if st.recursive:
            while blocks * fanout < n_leaves and d < st.max_depth:
                blocks *= fanout
                d += 1
        blocks *= fanout
        depths.append(d)
    return tuple(depths)


@dataclasses.dataclass
class ChainStatics:
    """One chain's workload-free structure, flattened to tuples.

    Everything here follows from (chain, depth signature): the expanded
    level stats, node counts (pure fanout products), node bytes, internal
    cache regions, and the structural ``template`` grouping chains whose
    record layout is identical up to numeric values.  Shared via the
    ``chain_statics`` memo; treat instances as immutable.
    """

    stats: Tuple[ElementStatics, ...]   # per expanded internal level
    n_nodes: Tuple[float, ...]
    node_bytes: Tuple[float, ...]
    region: Tuple[float, ...]           # path-so-far cache region (internal)
    term: ElementStatics
    blocks_final: float                 # block count after the division loop
    use_blocks: bool                    # terminal count sees blocks_final
    termcap: int                        # terminal capacity or 256
    cum_int_bytes: float                # total internal-level bytes
    template: Tuple
    depths: Tuple[int, ...]

    @property
    def n_internal(self) -> int:
        return len(self.stats)


#: (chain, depth signature) -> ChainStatics — workload never in the key;
#: snapshot-enabled (pure structural values, no model ids to remap)
_CHAIN_STATICS = DictCache(maxsize=65536, name="chain_statics",
                           snapshot=True)


def _compute_chain_statics(chain: Tuple[Element, ...],
                           depths: Tuple[int, ...]) -> ChainStatics:
    term_st = statics_of(chain[-1])
    stats: List[ElementStatics] = []
    nodes: List[float] = []
    nbytes: List[float] = []
    blocks = 1
    for element, d in zip(chain[:-1], depths):
        st = statics_of(element)
        if st.fanout is None and st.unlimited:
            stats.append(st)
            nodes.append(float(blocks))
            nbytes.append(PTR_BYTES * 2.0)
            continue
        fanout = st.fanout or 2
        for _ in range(d):
            stats.append(st)
            nodes.append(float(blocks))
            nbytes.append(st.node_bytes)
            blocks *= fanout
    region: List[float] = []
    cumulative = 0.0
    for st, nn, nb in zip(stats, nodes, nbytes):
        cumulative += nn * nb
        r = cumulative
        if st.bfs:
            group = (st.fanout or 2) * nb
            r = min(cumulative, max(group, nb))
        region.append(r)
    template = (tuple(st.cls for st in stats),
                (term_st.sorted_keys, term_st.bloom_bits > 0.0,
                 term_st.layout, term_st.value_fetch, term_st.area_links))
    return ChainStatics(
        stats=tuple(stats), n_nodes=tuple(nodes), node_bytes=tuple(nbytes),
        region=tuple(region), term=term_st, blocks_final=float(blocks),
        use_blocks=len(chain) > 1 and not statics_of(chain[-2]).unlimited,
        termcap=term_st.capacity or 256, cum_int_bytes=cumulative,
        template=template, depths=depths)


def chain_statics(chain: Tuple[Element, ...], n_entries: int
                  ) -> ChainStatics:
    """The workload-free template statics of a chain.

    ``n_entries`` only selects the depth signature; the memo key is
    (chain, signature) — every workload that lands on the same structure
    is one cache entry (the statics cache-key invariant)."""
    depths = _expansion_depths(chain, n_entries)
    key = (chain, depths)
    st = _CHAIN_STATICS.get(key)
    if st is None:
        st = _compute_chain_statics(chain, depths)
        _CHAIN_STATICS.put(key, st)
    return st


# ---------------------------------------------------------------------------
# Per-chain geometry — statics + one workload's numerics (inspection API)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChainGeometry:
    """One chain's instantiated level structure under one workload.

    The statics half is shared via :func:`chain_statics`; only the
    workload numerics (entries per node, terminal counts/regions) are
    computed here.  ``template`` is the structural fingerprint grouping
    chains whose record layout is identical up to numeric values — the
    argument :func:`repro_torch.core.synthesis.symbolic_breakdown` takes.

    Not ``frozen=True`` — instances are shared via the ``chain_geometry``
    memo and must be treated as immutable, but the frozen dataclass
    ``__setattr__`` init path costs more than the whole geometry
    computation at search-frontier scale.
    """

    stats: Tuple[ElementStatics, ...]   # per expanded internal level
    n_nodes: Tuple[float, ...]
    node_bytes: Tuple[float, ...]
    epn: Tuple[float, ...]              # entries routed per node
    region: Tuple[float, ...]           # path-so-far cache region
    term: ElementStatics
    t_n_nodes: float
    t_epn: float
    t_region: float
    total_bytes: float
    n: float                            # max(n_entries, 1)
    n_raw: float                        # workload.n_entries as-is
    termcap: int                        # terminal capacity or 256
    template: Tuple

    @property
    def n_internal(self) -> int:
        return len(self.stats)


@functools.lru_cache(maxsize=65536)
def chain_geometry(chain: Tuple[Element, ...], workload: Workload
                   ) -> ChainGeometry:
    """One chain's geometry under one workload — mirrors
    ``synthesis._instantiate_levels`` value for value (same int/float op
    sequence, asserted by the record-parity tests).  The structure comes
    from the workload-free :func:`chain_statics`; only the numeric
    columns are workload-keyed."""
    st = chain_statics(chain, workload.n_entries)
    n = max(workload.n_entries, 1)
    capacity = st.termcap
    n_leaves = max(math.ceil(n / capacity), 1)
    entries = float(n)
    epn = tuple(entries / nn for nn in st.n_nodes)
    if st.use_blocks:
        n_term = max(n_leaves, int(st.blocks_final))
    else:
        n_term = n_leaves
    term_bytes = min(capacity, n / max(n_term, 1)) * workload.pair_bytes
    term_bytes = max(term_bytes, float(workload.pair_bytes))
    cumulative = st.cum_int_bytes + n_term * term_bytes
    t_region = cumulative
    if st.term.bfs:
        group = (st.term.fanout or 2) * term_bytes
        t_region = min(cumulative, max(group, term_bytes))
    return ChainGeometry(
        stats=st.stats, n_nodes=st.n_nodes, node_bytes=st.node_bytes,
        epn=epn, region=st.region, term=st.term,
        t_n_nodes=float(int(n_term)), t_epn=entries / max(n_term, 1),
        t_region=t_region, total_bytes=cumulative, n=entries,
        n_raw=float(workload.n_entries), termcap=capacity,
        template=st.template)


def clear_template_caches() -> None:
    with MEMO_LOCK:
        chain_geometry.cache_clear()
        _expansion_depths.cache_clear()
        _CHAIN_STATICS.clear()
        _SEGMENT_IDS.clear()
        _STATICS_BY_VALUE.clear()


def cache_info() -> Dict[str, Tuple]:
    return {"chain_geometry": chain_geometry.cache_info(),
            "chain_statics": _CHAIN_STATICS.info(),
            "segment_statics": _SEGMENT_IDS.info()}


def segment_ranges(tile_segments: np.ndarray, n_segments: int,
                   n_parts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous per-shard segment ranges over a packed record layout.

    Returns ``(seg_cuts, tile_cuts)``, each of length ``n_parts + 1``:
    ``seg_cuts`` splits ``[0, n_segments)`` into ~equal contiguous
    ranges (round-balanced) and ``tile_cuts`` maps each cut onto the
    sorted per-tile segment ids, so shard ``d`` owns tiles
    ``tile_cuts[d]:tile_cuts[d+1]`` — records ``* TILE``.  Design blocks
    are tile-aligned by construction, so tile cuts never split a design;
    every segment's records land wholly in one shard, which is what
    keeps sharded totals bit-identical to the flat reduction.  Shared by
    the scorer's per-segment launch layout and ``PackedFrontier.split``."""
    seg_cuts = np.asarray([round(n_segments * d / n_parts)
                           for d in range(n_parts + 1)])
    tile_cuts = np.searchsorted(tile_segments, seg_cuts, side="left")
    return seg_cuts, tile_cuts


# ---------------------------------------------------------------------------
# Flat SoA tables over all chains being packed (structural half)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Tables:
    """Workload-free columns: the (chain, mix) half of every segment."""

    # internal-level table, one row per expanded internal level
    ch: np.ndarray          # owning chain index
    lvl: np.ndarray         # level position within the chain
    cls: np.ndarray
    fanout: np.ndarray
    n_nodes: np.ndarray
    node_bytes: np.ndarray
    region: np.ndarray      # internal cache regions (structural)
    fences: np.ndarray
    bloom_bits: np.ndarray
    termcap: np.ndarray     # owning chain's terminal capacity
    # terminal table, one row per chain
    c_n_int: np.ndarray     # internal level count (terminal order base)
    c_t_sorted: np.ndarray
    c_t_value_fetch: np.ndarray
    c_t_area: np.ndarray
    c_t_bloom: np.ndarray
    c_mid_search: np.ndarray   # layout-resolved sorted-search model id
    c_mid_scan: np.ndarray     # layout-resolved equal-scan model id
    c_mid_rscan: np.ndarray    # layout-resolved range-scan model id
    c_termcap: np.ndarray
    c_blocks_final: np.ndarray
    c_use_blocks: np.ndarray
    c_cum_int_bytes: np.ndarray
    c_term_bfs: np.ndarray
    c_term_fanout: np.ndarray


def _build_tables(statics_list: Sequence[ChainStatics]) -> _Tables:
    i_rows: List[Tuple] = []
    c_rows: List[Tuple] = []
    for c, g in enumerate(statics_list):
        for j, st in enumerate(g.stats):
            i_rows.append((c, j, st.cls, float(st.fanout or 0),
                           g.n_nodes[j], g.node_bytes[j], g.region[j],
                           st.fences, st.bloom_bits, float(g.termcap)))
        t = g.term
        c_rows.append((g.n_internal, t.sorted_keys, t.value_fetch,
                       t.area_links, t.bloom_bits,
                       _mid(access.SORTED_SEARCH, t.layout),
                       _mid(access.SCAN, t.layout),
                       _mid(access.SCAN, t.layout, "range"),
                       float(g.termcap), g.blocks_final, g.use_blocks,
                       g.cum_int_bytes, t.bfs, float(t.fanout or 2)))
    icols = list(zip(*i_rows)) if i_rows else [[] for _ in range(10)]
    ccols = list(zip(*c_rows))
    f8, i8 = np.float64, np.int64
    return _Tables(
        ch=np.asarray(icols[0], i8), lvl=np.asarray(icols[1], i8),
        cls=np.asarray(icols[2], i8), fanout=np.asarray(icols[3], f8),
        n_nodes=np.asarray(icols[4], f8),
        node_bytes=np.asarray(icols[5], f8),
        region=np.asarray(icols[6], f8), fences=np.asarray(icols[7], f8),
        bloom_bits=np.asarray(icols[8], f8),
        termcap=np.asarray(icols[9], f8),
        c_n_int=np.asarray(ccols[0], i8),
        c_t_sorted=np.asarray(ccols[1], bool),
        c_t_value_fetch=np.asarray(ccols[2], bool),
        c_t_area=np.asarray(ccols[3], bool),
        c_t_bloom=np.asarray(ccols[4], f8),
        c_mid_search=np.asarray(ccols[5], np.int32),
        c_mid_scan=np.asarray(ccols[6], np.int32),
        c_mid_rscan=np.asarray(ccols[7], np.int32),
        c_termcap=np.asarray(ccols[8], f8),
        c_blocks_final=np.asarray(ccols[9], f8),
        c_use_blocks=np.asarray(ccols[10], bool),
        c_cum_int_bytes=np.asarray(ccols[11], f8),
        c_term_bfs=np.asarray(ccols[12], bool),
        c_term_fanout=np.asarray(ccols[13], f8))


# ---------------------------------------------------------------------------
# Workload geometry columns — the numeric half, batched over a workload axis
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _WorkloadCols:
    """Per-workload numerics for one table set, shape ``[W, ...]``.

    Every column is one broadcast expression over the structural tables —
    the batched twin of the scalar block-division epilogue in
    :func:`chain_geometry`, evaluated for all sweep points at once."""

    workloads: Tuple[Workload, ...]
    key_bytes: np.ndarray      # [W]
    value_bytes: np.ndarray    # [W]
    pair_bytes: np.ndarray     # [W]
    selectivity: np.ndarray    # [W]
    n_raw: np.ndarray          # [W]
    epn: np.ndarray            # [W, L] entries per node, internal rows
    t_region_rows: np.ndarray  # [W, L] owning chain's terminal region
    t_n_nodes_rows: np.ndarray  # [W, L] owning chain's terminal node count
    c_t_n_nodes: np.ndarray    # [W, C]
    c_t_epn: np.ndarray        # [W, C]
    c_t_region: np.ndarray     # [W, C]
    c_total_bytes: np.ndarray  # [W, C]

    def mult_static(self, n_nodes: np.ndarray) -> np.ndarray:
        """Skew multipliers for structural node counts, one row per
        workload (zipf masses come from the shared synthesis memo)."""
        return np.stack([skew_multipliers(n_nodes, w)
                         for w in self.workloads])

    def mult_rows(self, n_nodes: np.ndarray) -> np.ndarray:
        """Skew multipliers for per-workload node counts ``[W, n]``."""
        return np.stack([skew_multipliers(n_nodes[i], w)
                         for i, w in enumerate(self.workloads)])


def _build_workload_cols(t: _Tables, workloads: Sequence[Workload]
                         ) -> _WorkloadCols:
    f8 = np.float64
    w_count = len(workloads)
    n = np.asarray([float(max(w.n_entries, 1)) for w in workloads], f8)
    pair = np.asarray([float(w.pair_bytes) for w in workloads], f8)
    n_col, pair_col = n[:, None], pair[:, None]
    n_leaves = np.maximum(np.ceil(n_col / t.c_termcap), 1.0)
    n_term = np.where(t.c_use_blocks,
                      np.maximum(n_leaves, t.c_blocks_final), n_leaves)
    safe_term = np.maximum(n_term, 1.0)
    term_bytes = np.maximum(
        np.minimum(t.c_termcap, n_col / safe_term) * pair_col, pair_col)
    cumulative = t.c_cum_int_bytes + n_term * term_bytes
    group = np.maximum(t.c_term_fanout * term_bytes, term_bytes)
    c_t_region = np.where(t.c_term_bfs,
                          np.minimum(cumulative, group), cumulative)
    if len(t.n_nodes):
        epn = n_col / t.n_nodes[None, :]
        t_region_rows = c_t_region[:, t.ch]
        t_n_nodes_rows = n_term[:, t.ch]
    else:
        epn = np.zeros((w_count, 0), f8)
        t_region_rows = np.zeros((w_count, 0), f8)
        t_n_nodes_rows = np.zeros((w_count, 0), f8)
    return _WorkloadCols(
        workloads=tuple(workloads),
        key_bytes=np.asarray([float(w.key_bytes) for w in workloads], f8),
        value_bytes=np.asarray([float(w.value_bytes) for w in workloads],
                               f8),
        pair_bytes=pair,
        selectivity=np.asarray([float(w.selectivity) for w in workloads],
                               f8),
        n_raw=np.asarray([float(w.n_entries) for w in workloads], f8),
        epn=epn, t_region_rows=t_region_rows,
        t_n_nodes_rows=t_n_nodes_rows, c_t_n_nodes=n_term,
        c_t_epn=n_col / safe_term, c_t_region=c_t_region,
        c_total_bytes=cumulative)


# ---------------------------------------------------------------------------
# Vectorized record emission (one numpy expression per class x slot,
# broadcast over the workload axis)
# ---------------------------------------------------------------------------
class _Rows:
    """Accumulates record columns: (chain, order, model id) are structural
    1-D arrays; sizes and counts carry the ``[W, n]`` workload axis."""

    def __init__(self, n_workloads: int) -> None:
        self.W = n_workloads
        self.parts: List[Tuple[np.ndarray, ...]] = []

    def emit(self, ch, order, mid, size, count=None) -> None:
        ch = np.asarray(ch, np.int64)
        n = len(ch)
        if n == 0:
            return
        if np.isscalar(mid):
            mid = np.full(n, mid, np.int32)
        size = np.asarray(size, np.float64)
        if size.ndim == 1:          # workload-independent sizes broadcast
            size = np.broadcast_to(size, (self.W, n))
        if count is None:
            count = np.ones((self.W, n))
        else:
            count = np.asarray(count, np.float64)
            if count.ndim == 1:
                count = np.broadcast_to(count, (self.W, n))
        self.parts.append((ch, np.asarray(order, np.int64),
                           np.asarray(mid, np.int32), size, count))

    def collect(self) -> Tuple[np.ndarray, ...]:
        if not self.parts:
            z = np.zeros(0)
            return (z.astype(np.int64), z.astype(np.int64),
                    z.astype(np.int32), np.zeros((self.W, 0)),
                    np.zeros((self.W, 0)))
        return (np.concatenate([p[0] for p in self.parts]),
                np.concatenate([p[1] for p in self.parts]),
                np.concatenate([p[2] for p in self.parts]),
                np.concatenate([p[3] for p in self.parts], axis=1),
                np.concatenate([p[4] for p in self.parts], axis=1))


def _emit_get(t: _Tables, wc: _WorkloadCols, rows: _Rows) -> None:
    kb = wc.key_bytes[:, None]
    # -- internal levels ----------------------------------------------------
    m = t.cls >= CLS_IND_FUNC                 # every class with its own P
    mult = wc.mult_static(t.n_nodes[m])
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS,
              _mid(access.RANDOM_ACCESS),
              np.maximum(t.region[m][None] * mult, 1.0))
    m = t.cls == CLS_SKIP                     # skip list: fence search
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS, _mid(access.SORTED_SEARCH),
              np.maximum(np.maximum(wc.epn[:, m] / t.termcap[m][None],
                                    1.0) * FENCE_BYTES, 1.0))
    m = t.cls == CLS_LL                       # linked list: head + hops
    pages = np.maximum(wc.epn[:, m] / t.termcap[m][None], 1.0)
    visited = (pages + 1.0) / 2.0
    mult = wc.mult_rows(wc.t_n_nodes_rows[:, m])
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS, _mid(access.RANDOM_ACCESS),
              np.maximum(wc.t_region_rows[:, m] * mult, 1.0))
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS + 1, _mid(access.RANDOM_ACCESS),
              wc.t_region_rows[:, m], np.maximum(visited - 1.0, 0.0))
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS + 2, _mid(access.SCAN),
              t.termcap[m][None] * kb, np.maximum(visited - 1.0, 0.0))
    m = t.cls == CLS_IND_FUNC                 # hash partitioning probe
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS + 1, _mid(access.HASH_PROBE),
              np.maximum(t.n_nodes[m] * np.maximum(t.fanout[m], 1.0) *
                         PTR_BYTES, 1.0))
    m = (t.cls == CLS_DEP) | (t.cls == CLS_DEP_BLOOM)   # sorted fences
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS + 1,
              _mid(access.SORTED_SEARCH, "row-wise"),
              np.maximum(t.fences[m] * FENCE_BYTES, 1.0))
    m = t.cls == CLS_DEP_BLOOM
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS + 2, _mid(access.BLOOM_PROBE),
              np.maximum(t.bloom_bits[m] / 8.0, 1.0))
    m = t.cls == CLS_APPEND                   # append partitioning scan
    rows.emit(t.ch[m], t.lvl[m] * _SLOTS + 1, _mid(access.SCAN),
              np.maximum(np.where(t.fanout[m] > 0, t.fanout[m], 2.0) *
                         FENCE_BYTES, 1.0))
    # -- terminal node ------------------------------------------------------
    ch = np.arange(len(t.c_n_int))
    base = t.c_n_int * _SLOTS
    entries = np.maximum(wc.c_t_epn, 1.0)
    mult = wc.mult_rows(wc.c_t_n_nodes)
    rows.emit(ch, base, _mid(access.RANDOM_ACCESS),
              np.maximum(wc.c_t_region * mult, 1.0))
    m = t.c_t_bloom > 0.0
    rows.emit(ch[m], base[m] + 1, _mid(access.BLOOM_PROBE),
              np.maximum(t.c_t_bloom[m] / 8.0, 1.0))
    m = t.c_t_sorted
    rows.emit(ch[m], base[m] + 2, t.c_mid_search[m],
              np.maximum(entries[:, m] * kb, 1.0))
    m = ~t.c_t_sorted
    rows.emit(ch[m], base[m] + 2, t.c_mid_scan[m],
              entries[:, m] * kb / 2.0)
    m = t.c_t_value_fetch
    rows.emit(ch[m], base[m] + 3, _mid(access.RANDOM_ACCESS),
              np.maximum(entries[:, m] * wc.value_bytes[:, None], 1.0))


def _emit_tail_range(t: _Tables, wc: _WorkloadCols, rows: _Rows) -> None:
    """Fig. 10 range sweep appended after the get descent."""
    ch = np.arange(len(t.c_n_int))
    base = (t.c_n_int + 1) * _SLOTS
    frac = np.maximum(wc.selectivity, 0.0)[:, None]
    n_pages = np.maximum(np.ceil(frac * wc.c_t_n_nodes), 1.0)
    hop = np.where(t.c_t_area[None, :] | (wc.c_t_n_nodes == 1.0),
                   wc.c_t_region, wc.c_total_bytes)
    rows.emit(ch, base, _mid(access.RANDOM_ACCESS), hop,
              np.maximum(n_pages - 1.0, 0.0))
    rows.emit(ch, base + 1, t.c_mid_rscan,
              np.maximum(wc.c_t_epn, 1.0) * wc.key_bytes[:, None],
              n_pages)


def _emit_bulk_load(t: _Tables, wc: _WorkloadCols, rows: _Rows) -> None:
    n_chains = len(t.c_n_int)
    ch = np.arange(n_chains)
    data_bytes = np.broadcast_to((wc.n_raw * wc.pair_bytes)[:, None],
                                 (rows.W, n_chains))
    nr = np.broadcast_to(wc.n_raw[:, None], (rows.W, n_chains))
    m = t.c_t_sorted
    rows.emit(ch[m], np.zeros(int(m.sum()), np.int64), _mid(access.SORT),
              np.maximum(nr[:, m], 1.0))
    rows.emit(ch[m], np.ones(int(m.sum()), np.int64),
              _mid(access.ORDERED_BATCH_WRITE),
              np.maximum(data_bytes[:, m], 1.0))
    m = ~t.c_t_sorted
    rows.emit(ch[m], np.zeros(int(m.sum()), np.int64),
              _mid(access.SERIAL_WRITE),
              np.maximum(data_bytes[:, m], 1.0))
    level_bytes = np.maximum(t.n_nodes * t.node_bytes, 1.0)
    base = (t.lvl + 1) * _SLOTS
    m = (t.cls == CLS_IND) | (t.cls == CLS_IND_FUNC)
    rows.emit(t.ch[m], base[m], _mid(access.SCAN),
              np.maximum(data_bytes[:, t.ch[m]], 1.0))
    rows.emit(t.ch[m], base[m] + 1, _mid(access.SCATTERED_BATCH_WRITE),
              np.maximum(level_bytes[m], 1.0))
    m = ~m
    rows.emit(t.ch[m], base[m], _mid(access.ORDERED_BATCH_WRITE),
              np.maximum(level_bytes[m], 1.0))


def emit_operation(op: str, t: _Tables, wc: _WorkloadCols
                   ) -> Tuple[np.ndarray, ...]:
    """Record columns (chain, order, model id, sizes ``[W, n]``, counts
    ``[W, n]``) of one operation over every chain and every workload in
    the tables — the vectorized twin of
    ``synthesis.synthesize_operation`` + ``batchcost.compile_breakdown``,
    with a workload axis."""
    rows = _Rows(len(wc.workloads))
    if op == "get":
        _emit_get(t, wc, rows)
    elif op == "range_get":
        _emit_get(t, wc, rows)
        _emit_tail_range(t, wc, rows)
    elif op == "update":
        _emit_get(t, wc, rows)
        ch = np.arange(len(t.c_n_int))
        rows.emit(ch, (t.c_n_int + 1) * _SLOTS, _mid(access.SERIAL_WRITE),
                  np.broadcast_to(np.maximum(wc.value_bytes, 1.0)[:, None],
                                  (rows.W, len(ch))))
    elif op == "bulk_load":
        _emit_bulk_load(t, wc, rows)
    else:
        raise KeyError(op)
    return rows.collect()


# ---------------------------------------------------------------------------
# Assembly: per-spec tile-padded segments, for every sweep point at once
# ---------------------------------------------------------------------------
#: (template, ops) -> interned per-chain model-id array — workload-free:
#: every workload of a sweep (and every chain sharing a template)
#: references the SAME ids array object
_SEGMENT_IDS = DictCache(maxsize=65536, name="segment_statics",
                         snapshot=True)


def _restore_segment_ids(value, env):
    """Remap a snapshotted interned per-chain model-id array onto the
    live interning table (warm-restart restore)."""
    ids = env["model_ids"][np.asarray(value, dtype=np.int64)]
    ids = np.ascontiguousarray(ids)
    ids.setflags(write=False)
    return ids


memo.register_restore_transform("segment_statics", _restore_segment_ids)


def _frozen(arr: np.ndarray) -> np.ndarray:
    """An owned, read-only copy of one segment column."""
    arr = arr.copy()
    arr.setflags(write=False)
    return arr


def _intern_segment_ids(template: Tuple, ops: Tuple[str, ...],
                        ids: np.ndarray) -> np.ndarray:
    key = (template, ops)
    cached = _SEGMENT_IDS.get(key)
    if cached is not None and len(cached) == len(ids):
        return cached
    _SEGMENT_IDS.put(key, ids)
    return ids


def _pack_group(chains: Sequence[Tuple[Element, ...]],
                points: Sequence[Tuple[Workload, Tuple]],
                ops: Tuple[str, ...], pidx: List[int],
                out: List[List]) -> None:
    """Pack one (op sequence, structural signature) group of sweep points:
    statics and the argsorted record layout are computed once; sizes and
    weights carry the group's workload axis."""
    n_chains = len(chains)
    workloads = [points[pi][0] for pi in pidx]
    statics_list = [chain_statics(c, workloads[0].n_entries)
                    for c in chains]
    t = _build_tables(statics_list)
    wc = _build_workload_cols(t, workloads)
    # op weights are per sweep point: a read/write-ratio sweep shares all
    # statics and numerics, only this [n_ops, W] table varies
    op_weights = np.asarray([[points[pi][1][pos][1] for pi in pidx]
                             for pos in range(len(ops))], np.float64)
    ch_parts, key_parts, mid_parts, size_parts, w_parts = [], [], [], [], []
    for pos, op in enumerate(ops):
        ch, order, mid, sizes, counts = emit_operation(op, t, wc)
        ch_parts.append(ch)
        key_parts.append(order + pos * _OP_STRIDE)
        mid_parts.append(mid)
        size_parts.append(sizes)
        w_parts.append(counts * op_weights[pos][:, None])
    ch = np.concatenate(ch_parts)
    key = ch * (_OP_STRIDE * len(ops)) + np.concatenate(key_parts)
    mids = np.concatenate(mid_parts)
    sizes = np.concatenate(size_parts, axis=1)
    weights = np.concatenate(w_parts, axis=1)

    # the order key is structural, so ONE argsort serves every workload
    idx = np.argsort(key, kind="stable")
    ch, mids = ch[idx], mids[idx]
    sizes, weights = sizes[:, idx], weights[:, idx]

    counts = np.bincount(ch, minlength=n_chains)
    # every chain must emit exactly its template's symbolic record schema
    # (the once-per-template breakdown synthesis.py declares); a mismatch
    # means the vectorized emission drifted from the expert system
    expected_by_template: Dict[Tuple, int] = {}
    for c, st in enumerate(statics_list):
        expected = expected_by_template.get(st.template)
        if expected is None:
            expected = sum(len(symbolic_breakdown(op, st.template))
                           for op in ops)
            expected_by_template[st.template] = expected
        if counts[c] != expected:
            raise AssertionError(
                f"template emission drift: chain {c} produced {counts[c]} "
                f"records, schema says {expected} (template {st.template})")
    padded = counts + (-counts % TILE)
    pad_off = np.concatenate([[0], np.cumsum(padded)])
    raw_off = np.concatenate([[0], np.cumsum(counts)])
    total = int(pad_off[-1])
    out_ids = np.empty(total, np.int32)
    out_sizes = np.ones((len(pidx), total), np.float64)
    out_weights = np.zeros((len(pidx), total), np.float64)
    # pad rows repeat the block's first real model id (see the pad-id note
    # in batchcost); fill per chain, then scatter the real rows over it
    out_ids[:] = np.repeat(mids[raw_off[:-1]], padded)
    pos_idx = np.arange(len(ch)) + np.repeat(pad_off[:-1] - raw_off[:-1],
                                             counts)
    out_ids[pos_idx] = mids
    out_sizes[:, pos_idx] = sizes
    out_weights[:, pos_idx] = weights
    # per-chain segments are COPIES, not views: cached segments outlive
    # this call (batchcost's segment cache), and a view would pin the
    # whole group's [W, total] buffers alive for as long as any one
    # small chain stays cached
    for c, st in enumerate(statics_list):
        sl = slice(int(pad_off[c]), int(pad_off[c + 1]))
        ids_c = _intern_segment_ids(st.template, ops,
                                    _frozen(out_ids[sl]))
        for wi, pi in enumerate(pidx):
            out[pi][c] = (ids_c, _frozen(out_sizes[wi, sl]),
                          _frozen(out_weights[wi, sl]))


def pack_points(chains: Sequence[Tuple[Element, ...]],
                points: Sequence[Tuple[Workload, Tuple]]
                ) -> List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Mix-weighted (ids, sizes, weights) per chain for EVERY sweep point.

    ``points`` is a sequence of ``(workload, mix_items)`` pairs; the
    result is indexed ``[point][chain]``.  Points sharing an op sequence
    and a joint structural signature (the common case: read/write-ratio,
    skew, selectivity or query-count sweeps over a fixed data size) are
    packed as ONE group — statics, emission layout and the argsort are
    computed once, and all numeric columns are evaluated with a workload
    axis.  Points whose ``n_entries`` changes a chain's expansion depths
    simply land in their own group.
    """
    n_chains = len(chains)
    points = tuple(points)
    out: List[List] = [[None] * n_chains for _ in points]
    if n_chains == 0 or not points:
        return out
    groups: Dict[Tuple, List[int]] = {}
    for pi, (workload, mix_items) in enumerate(points):
        ops = tuple(op for op, _ in mix_items)
        sig = tuple(_expansion_depths(chain, workload.n_entries)
                    for chain in chains)
        groups.setdefault((ops, sig), []).append(pi)
    for (ops, _), pidx in groups.items():
        _pack_group(chains, points, ops, pidx, out)
    return out


def pack_specs(chains: Sequence[Tuple[Element, ...]], workload: Workload,
               mix_items: Tuple[Tuple[str, float], ...]
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Single-workload wrapper over :func:`pack_points` — the vectorized
    equivalent of packing every chain through the scalar
    ``instantiate -> synthesize -> compile -> pad`` pipeline."""
    if not chains:
        return []
    return pack_points(chains, ((workload, mix_items),))[0]
