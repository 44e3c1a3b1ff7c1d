"""Elements and data structure specifications (paper §2, Appendix F).

An *element* is a full assignment of layout primitives describing one node
type.  A *specification* is a hierarchy of elements: each non-terminal
element partitions its block of data into sub-blocks handled by the next
element in the chain (recursion allowed onto the same element).

The element library below reproduces Figure 30 (UDP, ODP, Hash, Range, Trie,
B+, LL, SL) plus the CSB+ and FAST internal nodes of Figure 11.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.primitives import Value, tag_of, validate_assignment


@dataclasses.dataclass(frozen=True)
class Element:
    """A full specification of a single data structure node type."""

    name: str
    values: Tuple[Tuple[str, Value], ...]  # sorted (primitive, value) pairs

    def __post_init__(self) -> None:
        # primitive -> value index: get()/tag() are the synthesizer's hottest
        # calls (dozens per costed design); not a dataclass field, so eq/hash
        # still compare (name, values) only
        object.__setattr__(self, "_lookup", dict(self.values))
        # frontier packing hashes every element chain on each memo lookup
        # (thousands of designs per batched call) — hash the nested value
        # tuples once, not per lookup
        object.__setattr__(self, "_hash", hash((self.name, self.values)))
        # synthesis statics slot: repro_torch.core.templatecost resolves every
        # tag/model the synthesizer reads into one record, lazily, and pins
        # it here so the vectorized geometry pass pays a single attribute
        # read per level instead of dozens of tag() dict lookups (equal
        # elements share one record via templatecost's by-value registry)
        object.__setattr__(self, "_tc_statics", None)

    @staticmethod
    def make(name: str, **values: Value) -> "Element":
        errors = validate_assignment(values)
        if errors:
            raise ValueError(f"invalid element {name}: {errors}")
        return Element(name, tuple(sorted(values.items())))

    def get(self, primitive: str, default: Value = None) -> Value:
        return self._lookup.get(primitive, default)

    def tag(self, primitive: str, default: str = "none") -> str:
        value = self.get(primitive)
        return tag_of(value) if value is not None else default

    # -- convenience accessors used by the cost synthesizer ----------------
    @property
    def terminal(self) -> bool:
        return self.tag("fanout") == "terminal"

    @property
    def capacity(self) -> Optional[int]:
        fanout = self.get("fanout")
        if isinstance(fanout, tuple) and fanout[0] == "terminal":
            return int(fanout[1])
        return None

    @property
    def fanout(self) -> Optional[int]:
        value = self.get("fanout")
        if isinstance(value, tuple) and value[0] == "fixed":
            return int(value[1])
        return None  # unlimited / terminal / func

    @property
    def sorted_keys(self) -> bool:
        return self.tag("key_partitioning") == "data-dep"

    @property
    def retains_keys(self) -> bool:
        return self.tag("key_retention") != "no"

    @property
    def retains_values(self) -> bool:
        return self.tag("value_retention") != "no"

    def with_values(self, **overrides: Value) -> "Element":
        values = dict(self.values)
        values.update(overrides)
        return Element.make(self.name, **values)


# the dataclass-generated __hash__ re-hashes the nested values tuples on
# every call; serve the precomputed one instead (assigned post-decoration —
# frozen dataclasses install their own __hash__ over a class-body override)
Element.__hash__ = lambda self: self._hash  # type: ignore[method-assign]


# ---------------------------------------------------------------------------
# Element library (Figure 30 / Figure 11 columns).
# ---------------------------------------------------------------------------
def _terminal(name: str, *, sorted_: bool, capacity: int = 256,
              area_links: str = "none", **extra: Value) -> Element:
    values: Dict[str, Value] = dict(
        key_retention="yes", value_retention="yes",
        key_value_layout="columnar", intra_node_access="direct",
        utilization=(">=", 0.5) if sorted_ else "none",
        bloom_filters="off", zone_map_filters="off",
        fanout=("terminal", capacity),
        key_partitioning=("data-dep", "sorted") if sorted_ else ("append", "fw"),
        immediate_node_links="none", skip_node_links="none",
        area_links=area_links,
    )
    values.update(extra)
    return Element.make(name, **values)


def unordered_data_page(capacity: int = 256) -> Element:
    return _terminal("UDP", sorted_=False, capacity=capacity,
                     utilization="none")


def ordered_data_page(capacity: int = 256) -> Element:
    return _terminal("ODP", sorted_=True, capacity=capacity,
                     area_links="forward")


def hash_element(buckets: int = 100) -> Element:
    return Element.make(
        "Hash",
        key_retention="no", value_retention="no",
        intra_node_access="direct", utilization="none",
        bloom_filters="off", zone_map_filters="off",
        fanout=("fixed", buckets),
        key_partitioning=("data-ind", "func", "mod"),
        sub_block_capacity="unrestricted",
        immediate_node_links="none", skip_node_links="none", area_links="none",
        sub_block_physical_location="pointed",
        sub_block_physical_layout="scatter",
        sub_blocks_homogeneous="true", sub_block_consolidation="false",
        sub_block_instantiation="lazy", recursion="no",
    )


def range_element(partitions: int = 100) -> Element:
    return Element.make(
        "Range",
        key_retention="no", value_retention="no",
        intra_node_access="direct", utilization="none",
        bloom_filters="off", zone_map_filters="off",
        fanout=("fixed", partitions),
        key_partitioning=("data-ind", "range", partitions),
        sub_block_capacity="unrestricted",
        immediate_node_links="none", skip_node_links="none", area_links="none",
        sub_block_physical_location="pointed",
        sub_block_physical_layout="scatter",
        sub_blocks_homogeneous="true", sub_block_consolidation="false",
        sub_block_instantiation="lazy", recursion="no",
    )


def trie_element(radix: int = 256, max_depth: int = 8) -> Element:
    return Element.make(
        "Trie",
        key_retention=("func", "radix"), value_retention=("func", "subset"),
        key_value_layout="columnar",
        intra_node_access="direct", utilization="none",
        bloom_filters="off", zone_map_filters="off",
        fanout=("fixed", radix),
        key_partitioning=("data-ind", "radix", radix),
        sub_block_capacity="unrestricted",
        immediate_node_links="none", skip_node_links="none", area_links="none",
        sub_block_physical_location="pointed",
        sub_block_physical_layout="scatter",
        sub_blocks_homogeneous="true", sub_block_consolidation="true",
        sub_block_instantiation="lazy", recursion=("yes", max_depth),
    )


def btree_internal(fanout: int = 20) -> Element:
    return Element.make(
        "B+",
        key_retention="no", value_retention="no",
        intra_node_access="direct", utilization=(">=", 0.5),
        bloom_filters="off", zone_map_filters="min",
        filters_memory_layout="scatter",
        fanout=("fixed", fanout),
        key_partitioning=("data-dep", "sorted"),
        sub_block_capacity="balanced",
        immediate_node_links="none", skip_node_links="none", area_links="none",
        sub_block_physical_location="pointed",
        sub_block_physical_layout="scatter",
        sub_blocks_homogeneous="true", sub_block_consolidation="false",
        sub_block_instantiation="lazy", recursion=("yes", "logn"),
    )


def csb_internal(fanout: int = 20) -> Element:
    """Cache-conscious B+tree internal node [75]: BFS children, one pointer."""
    base = btree_internal(fanout).with_values(sub_block_physical_layout="BFS")
    return Element("CSB+", base.values)


def fast_internal(fanout: int = 16, layer_group: int = 4) -> Element:
    """FAST [51]: inline homogeneous children, BFS layer grouping, no pointers."""
    base = btree_internal(fanout).with_values(
        key_partitioning=("data-dep", "k-ary", 4),
        sub_block_physical_location="inline",
        sub_block_physical_layout=("BFS-layer", layer_group),
    )
    return Element("FAST", base.values)


def linked_list_element(page_capacity: int = 256) -> Element:
    return Element.make(
        "LL",
        key_retention="no", value_retention="no",
        intra_node_access="head_link", utilization="none",
        bloom_filters="off", zone_map_filters="off",
        fanout="unlimited",
        key_partitioning=("append", "fw"),
        sub_block_capacity=("fixed", page_capacity),
        immediate_node_links="next", skip_node_links="none", area_links="none",
        sub_block_physical_location="inline",
        sub_block_physical_layout="scatter",
        sub_blocks_homogeneous="true", sub_block_consolidation="false",
        sub_block_instantiation="lazy", links_location="scatter",
        recursion="no",
    )


def skip_list_element(page_capacity: int = 256) -> Element:
    return Element.make(
        "SL",
        key_retention="no", value_retention="no",
        intra_node_access="head_link", utilization="none",
        bloom_filters="off", zone_map_filters="both",
        filters_memory_layout="scatter",
        fanout="unlimited",
        key_partitioning=("append", "fw"),
        sub_block_capacity=("fixed", page_capacity),
        immediate_node_links="next", skip_node_links="perfect",
        area_links="none",
        sub_block_physical_location="inline",
        sub_block_physical_layout="scatter",
        sub_blocks_homogeneous="true", sub_block_consolidation="false",
        sub_block_instantiation="lazy", links_location="scatter",
        recursion="no",
    )


# ---------------------------------------------------------------------------
# Specifications: chains of elements (Appendix F notation  A -> B -> C).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DataStructureSpec:
    name: str
    chain: Tuple[Element, ...]  # root element first; last must be terminal

    def __post_init__(self) -> None:
        if not self.chain:
            raise ValueError("spec needs at least one element")
        if not self.chain[-1].terminal:
            raise ValueError("last element must be terminal")
        for el in self.chain[:-1]:
            if el.terminal:
                raise ValueError("only the last element may be terminal")

    @property
    def terminal(self) -> Element:
        return self.chain[-1]

    def describe(self) -> str:
        return " -> ".join(e.name for e in self.chain)


# -- specifications used in the paper's experiments (Appendix F) ------------
def spec_array(n_puts: int) -> DataStructureSpec:
    return DataStructureSpec(
        "Array", (unordered_data_page(capacity=max(n_puts, 1)),))


def spec_sorted_array(n_puts: int) -> DataStructureSpec:
    return DataStructureSpec(
        "SortedArray", (ordered_data_page(capacity=max(n_puts, 1)),))


def spec_linked_list(page: int = 256) -> DataStructureSpec:
    return DataStructureSpec(
        "LinkedList", (linked_list_element(page), unordered_data_page(page)))


def spec_range_partitioned_linked_list(parts: int = 100,
                                       page: int = 256) -> DataStructureSpec:
    return DataStructureSpec(
        "RangePartitionedLinkedList",
        (range_element(parts), linked_list_element(page),
         unordered_data_page(page)))


def spec_skip_list(page: int = 256) -> DataStructureSpec:
    # NOTE: Appendix F writes SL -> UDP, but the paper's own cost output
    # (G.1) binary-searches the target page — B(256) — i.e. pages behave as
    # ordered data pages.  We follow the cost output (and our ground truth).
    return DataStructureSpec(
        "SkipList", (skip_list_element(page), ordered_data_page(page)))


def spec_trie(radix: int = 256, depth: int = 8,
              page: int = 256) -> DataStructureSpec:
    return DataStructureSpec(
        "Trie", (trie_element(radix, depth), unordered_data_page(page)))


def spec_btree(fanout: int = 20, page: int = 256) -> DataStructureSpec:
    return DataStructureSpec(
        "B+Tree", (btree_internal(fanout), ordered_data_page(page)))


def spec_csb_tree(fanout: int = 20, page: int = 256) -> DataStructureSpec:
    return DataStructureSpec(
        "CSB+Tree", (csb_internal(fanout), ordered_data_page(page)))


def spec_fast(fanout: int = 16, page: int = 256) -> DataStructureSpec:
    return DataStructureSpec(
        "FAST", (fast_internal(fanout), ordered_data_page(page)))


def spec_hash_table(buckets: int = 100, page: int = 5) -> DataStructureSpec:
    return DataStructureSpec(
        "HashTable",
        (hash_element(buckets), linked_list_element(page),
         unordered_data_page(page)))


ALL_PAPER_SPECS = {
    "array": spec_array,
    "sorted_array": spec_sorted_array,
    "linked_list": spec_linked_list,
    "range_partitioned_linked_list": spec_range_partitioned_linked_list,
    "skip_list": spec_skip_list,
    "trie": spec_trie,
    "btree": spec_btree,
    "csb_tree": spec_csb_tree,
    "fast": spec_fast,
    "hash_table": spec_hash_table,
}
