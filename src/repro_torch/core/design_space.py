"""Design-space cardinality accounting — paper §2, Equations 1–4.

Reproduces the paper's headline numbers: |E| ~ 1e16 valid node elements,
~1e32 standard two-element structures, >1e100 polymorphic designs for 1e15
keys, and the comparisons against fixed-library synthesis in Appendix B.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.core.primitives import PRIMITIVES

#: the paper excludes ~60 invalid combinations in Figure 11's accounting and
#: reports the total as ``> 10^18 / 60 invalid combinations ~ 10^16``.
INVALID_COMBINATION_FACTOR = 60


def element_cardinality() -> float:
    """|E| per Equation 1 over the full (Figure 11) primitive domains."""
    total = 1.0
    for prim in PRIMITIVES.values():
        total *= prim.cardinality
    return total / INVALID_COMBINATION_FACTOR


def standard_design_cardinality(num_elements: int = 2) -> float:
    """Equation 4: |E|^k for structures built from k distinct elements."""
    return element_cardinality() ** num_elements


def polymorphic_design_cardinality(num_keys: float, page_size: int = 4096,
                                   fanout: int = 20) -> float:
    """Equation 3: |E| * (f * |E|)^ceil(log_f N) (log-domain to avoid overflow).

    Returns log10 of the count (the count itself overflows floats for the
    paper's 1e15-key example).
    """
    card = element_cardinality()
    pages = max(math.ceil(num_keys / page_size), 1)
    height = max(math.ceil(math.log(pages, fanout)), 1)
    log10 = math.log10(card) + height * (math.log10(fanout) + math.log10(card))
    return log10


def fixed_library_cardinality(library_size: int, num_elements: int = 2) -> int:
    """Appendix B comparison: designs from a fixed library of k structures."""
    return library_size ** num_elements


def summary() -> Dict[str, float]:
    return {
        "element_cardinality_log10": math.log10(element_cardinality()),
        "standard_two_element_log10": math.log10(standard_design_cardinality(2)),
        "standard_three_element_log10": math.log10(standard_design_cardinality(3)),
        "polymorphic_1e15_keys_log10": polymorphic_design_cardinality(1e15),
        "polymorphic_10m_4k_pages_log10": polymorphic_design_cardinality(1e7),
        "fixed_library_5_two_element": fixed_library_cardinality(5, 2),
    }
