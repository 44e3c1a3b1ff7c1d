"""Public sorted-search ops: ``sorted_search`` ranks and the ``sorted_get``
point lookup (the Data Calculator's Get over an ODP terminal node).

CUDA tensors launch kernel K1 (:mod:`.kernel`); CPU tensors take the
plain versions (:mod:`.ref`); any other device raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.sorted_search import kernel, ref


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sorted_search runs on cpu or cuda, not "
                         f"{t.device}")
    return t.device.type


def sorted_search(keys: torch.Tensor, queries: torch.Tensor
                  ) -> torch.Tensor:
    """searchsorted(keys, queries, side='right') as int32; keys must be
    sorted ascending."""
    if _route(queries) == "cuda":
        return kernel.sorted_search_kernel(keys, queries)
    return ref.sorted_search_ref(keys, queries)


def sorted_get(keys: torch.Tensor, values: torch.Tensor,
               queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point Get over a sorted columnar node: (found mask, values), the
    ``SortedSearch(ColumnStore) + RandomAccess(value)`` sequence."""
    if _route(queries) == "cuda":
        return kernel.sorted_get_kernel(keys, values, queries)
    return ref.sorted_get_ref(keys, values, queries)
