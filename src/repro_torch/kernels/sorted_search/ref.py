"""Plain PyTorch versions of kernel K1 (the oracle on every device)."""
from __future__ import annotations

from typing import Tuple

import torch


def sorted_search_ref(keys: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """rank[q] = #{i : keys[i] <= q}  (searchsorted side='right'), int32.

    A NaN query compares false with every key, so its rank is 0, as K1
    and the reference op count it; ``torch.searchsorted`` alone would
    sort NaN last and answer N."""
    rank = torch.searchsorted(keys, queries, right=True).to(torch.int32)
    if queries.is_floating_point():
        rank = torch.where(torch.isnan(queries), torch.zeros_like(rank),
                           rank)
    return rank


def sorted_get_ref(keys: torch.Tensor, values: torch.Tensor,
                   queries: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found mask, values) of point lookups over sorted ``keys``."""
    ranks = sorted_search_ref(keys, queries).long()
    idx = torch.clamp(ranks - 1, 0, keys.shape[0] - 1)
    found = keys[idx] == queries
    return found, torch.where(found, values[idx],
                              torch.zeros((), dtype=values.dtype,
                                          device=values.device))
