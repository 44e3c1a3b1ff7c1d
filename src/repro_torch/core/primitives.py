"""Data layout primitives — the paper's §2 / Appendix C design space.

Each of the 21 primitives has a name, a domain of values, and (optionally)
rules that invalidate it in combination with other primitive settings.
A full assignment of primitives is an *element* (see elements.py).

Domains follow Figure 11 / Appendix C of the paper.  Parameterized values
(e.g. ``fixed(20)``) are represented as ``(tag, args...)`` tuples so that
elements are hashable and comparable.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

Value = Any  # str tag or (tag, args...) tuple


@dataclasses.dataclass(frozen=True)
class Primitive:
    """One data layout primitive and its (possibly reduced) value domain."""

    name: str
    #: canonical value tags, e.g. ("yes", "no", "func")
    tags: Tuple[str, ...]
    #: representative concrete values used for search/enumeration
    domain: Tuple[Value, ...]
    #: full-domain cardinality per the paper's accounting (Figure 11 "size")
    cardinality: int
    doc: str = ""

    def validate(self, value: Value) -> bool:
        tag = value[0] if isinstance(value, tuple) else value
        return tag in self.tags


def _p(name: str, tags: Sequence[str], domain: Sequence[Value], card: int,
       doc: str = "") -> Primitive:
    return Primitive(name, tuple(tags), tuple(domain), card, doc)


# ---------------------------------------------------------------------------
# The 21 primitives (Appendix C), with the paper's reduced-domain cardinality
# used for the design-space size accounting (Figure 11 rightmost "size" col).
# ---------------------------------------------------------------------------
PRIMITIVES: Dict[str, Primitive] = {p.name: p for p in [
    _p("key_retention", ("yes", "no", "func"), ("yes", "no", ("func", "radix")), 3,
       "Whether a node stores keys fully / not at all / partially (tries)."),
    _p("value_retention", ("yes", "no", "func"), ("yes", "no", ("func", "subset")), 3,
       "Whether a node stores values."),
    _p("key_value_layout", ("row-wise", "columnar", "col-row-groups"),
       ("row-wise", "columnar", ("col-row-groups", 64)), 102,
       "Physical layout of key-value pairs. Requires some retention."),
    _p("intra_node_access", ("direct", "head_link", "tail_link", "func"),
       ("direct", "head_link", "tail_link"), 4,
       "How sub-blocks are addressed within a node."),
    _p("utilization", ("none", ">=", "func"), ("none", (">=", 0.5)), 3,
       "Capacity utilization constraint (e.g. B+tree >=50%)."),
    _p("bloom_filters", ("off", "on"), ("off", ("on", 2, 1 << 13), ("on", 4, 1 << 16)),
       1001, "Per-sub-block bloom filters (num_hashes, num_bits)."),
    _p("zone_map_filters", ("min", "max", "both", "exact", "off"),
       ("min", "max", "both", "exact", "off"), 5,
       "Fence/zone-map filters per sub-block."),
    _p("filters_memory_layout", ("consolidate", "scatter"),
       ("consolidate", "scatter"), 2,
       "Filters contiguous for the element or scattered per sub-block. "
       "Requires bloom or zone maps on."),
    _p("fanout", ("fixed", "func", "unlimited", "terminal"),
       (("fixed", 20), ("fixed", 100), "unlimited", ("terminal", 256)), 22,
       "Sub-block count, or terminal node capacity."),
    _p("key_partitioning",
       ("append", "data-dep", "data-ind", "temporal"),
       (("append", "fw"), ("append", "bw"), ("data-dep", "sorted"),
        ("data-dep", "k-ary", 4), ("data-ind", "range", 100),
        ("data-ind", "radix", 8), ("data-ind", "func", "mod"),
        ("temporal", 10, "tier")), 406,
       "How keys map to sub-blocks / how data is ordered within the node."),
    _p("sub_block_capacity", ("fixed", "balanced", "unrestricted", "func"),
       (("fixed", 256), "balanced", "unrestricted"), 13,
       "Capacity of each sub-block. Requires fanout != terminal."),
    _p("immediate_node_links", ("next", "previous", "both", "none"),
       ("next", "previous", "both", "none"), 4,
       "Sibling links between sub-blocks."),
    _p("skip_node_links", ("perfect", "randomized", "func", "none"),
       ("perfect", ("randomized", 0.5), "none"), 13,
       "Skip links across sub-blocks (skip lists)."),
    _p("area_links", ("forward", "backward", "both", "none"),
       ("forward", "backward", "both", "none"), 4,
       "Leaf-level links across sub-trees (B+tree linked leaves)."),
    _p("sub_block_physical_location", ("inline", "pointed", "double-pointed", "none"),
       ("inline", "pointed", "double-pointed"), 4,
       "Sub-blocks inline in the parent vs pointed in heap. "
       "Requires fanout != terminal."),
    _p("sub_block_physical_layout", ("BFS", "BFS-layer", "scatter"),
       ("BFS", ("BFS-layer", 4), "scatter"), 5,
       "Physical order of sub-blocks (cache-conscious designs). "
       "Requires fanout != terminal."),
    _p("sub_blocks_homogeneous", ("true", "false"), ("true", "false"), 2,
       "All sub-blocks share one element definition. Requires non-terminal."),
    _p("sub_block_consolidation", ("true", "false"), ("true", "false"), 2,
       "Merge single children into parents. Requires non-terminal."),
    _p("sub_block_instantiation", ("lazy", "eager"), ("lazy", "eager"), 2,
       "Empty sub-blocks as null pointers (lazy) or materialized (eager)."),
    _p("links_location", ("consolidate", "scatter"), ("consolidate", "scatter"), 2,
       "Link storage. Requires some links."),
    _p("recursion", ("yes", "no"), (("yes", "logn"), ("yes", 8), "no"), 11,
       "Sub-blocks recursively use this element until max depth."),
]}


def tag_of(value: Value) -> str:
    return value[0] if isinstance(value, tuple) else value


# ---------------------------------------------------------------------------
# Invalidation rules (Figure 11 "Rules:" entries).  Each rule returns an error
# string when the combination is invalid, else None.
# ---------------------------------------------------------------------------
Rule = Callable[[Dict[str, Value]], Optional[str]]


def _rule_kv_layout(v: Dict[str, Value]) -> Optional[str]:
    if "key_value_layout" not in v:
        return None
    if tag_of(v.get("key_retention", "no")) == "no" and \
       tag_of(v.get("value_retention", "no")) == "no":
        return "key_value_layout requires key or value retention"
    return None


def _rule_filters_layout(v: Dict[str, Value]) -> Optional[str]:
    if "filters_memory_layout" not in v:
        return None
    if tag_of(v.get("bloom_filters", "off")) == "off" and \
       tag_of(v.get("zone_map_filters", "off")) == "off":
        return "filters_memory_layout requires bloom or zone map filters"
    return None


def _requires_non_terminal(name: str) -> Rule:
    def rule(v: Dict[str, Value]) -> Optional[str]:
        if name in v and tag_of(v.get("fanout", "unlimited")) == "terminal":
            return f"{name} requires fanout != terminal"
        return None
    return rule


def _rule_links_location(v: Dict[str, Value]) -> Optional[str]:
    if "links_location" not in v:
        return None
    if tag_of(v.get("immediate_node_links", "none")) == "none" and \
       tag_of(v.get("skip_node_links", "none")) == "none":
        return "links_location requires immediate or skip links"
    return None


def _rule_terminal_partitioning(v: Dict[str, Value]) -> Optional[str]:
    # terminal nodes cannot use data-independent partitioning into sub-blocks
    if tag_of(v.get("fanout", "unlimited")) == "terminal" and \
       tag_of(v.get("key_partitioning", ("append", "fw"))) == "data-ind":
        return "terminal node cannot partition data-independently into sub-blocks"
    return None


INVALIDATION_RULES: Tuple[Rule, ...] = (
    _rule_kv_layout,
    _rule_filters_layout,
    _requires_non_terminal("sub_block_capacity"),
    _requires_non_terminal("sub_block_physical_location"),
    _requires_non_terminal("sub_block_physical_layout"),
    _requires_non_terminal("sub_blocks_homogeneous"),
    _requires_non_terminal("sub_block_consolidation"),
    _requires_non_terminal("sub_block_instantiation"),
    _requires_non_terminal("recursion"),
    _rule_links_location,
    _rule_terminal_partitioning,
)


def validate_assignment(values: Dict[str, Value]) -> List[str]:
    """Return the list of invalidation errors for a primitive assignment."""
    errors: List[str] = []
    for name, value in values.items():
        prim = PRIMITIVES.get(name)
        if prim is None:
            errors.append(f"unknown primitive {name!r}")
        elif not prim.validate(value):
            errors.append(f"{name}: value {value!r} outside domain {prim.tags}")
    for rule in INVALIDATION_RULES:
        err = rule(values)
        if err:
            errors.append(err)
    return errors


def enumerate_elements(names: Sequence[str],
                       max_count: Optional[int] = None):
    """Yield valid assignments over the *reduced* domains of ``names``.

    Used by the auto-completion search (§4) to source candidate elements.
    """
    prims = [PRIMITIVES[n] for n in names]
    count = 0
    for combo in itertools.product(*(p.domain for p in prims)):
        values = dict(zip(names, combo))
        if not validate_assignment(values):
            yield values
            count += 1
            if max_count is not None and count >= max_count:
                return
