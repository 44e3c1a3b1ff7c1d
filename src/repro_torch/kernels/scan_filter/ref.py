"""Plain version of kernel K2 (the reference's ``scan_filter/ref.py``).

The same predicate tiles as the reference's oracle, taken a band of
queries at a time so that a [Q, N] tile of a large log never has to fit
in memory at once.
"""
from __future__ import annotations

from typing import Tuple

import torch

NOT_FOUND = 2147483647

#: most (query, key) pairs one band of the plain version holds
_BAND_PAIRS = 1 << 25


def scan_filter_ref(keys: torch.Tensor, queries: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first equal-match position | NOT_FOUND, range-match count), int32."""
    n, q = keys.shape[0], queries.shape[0]
    pos = torch.full((q,), NOT_FOUND, dtype=torch.int32, device=keys.device)
    cnt = torch.zeros((q,), dtype=torch.int32, device=keys.device)
    if n == 0:
        return pos, cnt
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)[None, :]
    band = max(1, _BAND_PAIRS // n)
    k = keys[None, :]
    for a in range(0, q, band):
        b = min(q, a + band)
        eq = k == queries[a:b, None]
        pos[a:b] = torch.where(eq, idx, NOT_FOUND).amin(dim=1)
        in_range = (k >= lo[a:b, None]) & (k < hi[a:b, None])
        cnt[a:b] = in_range.sum(dim=1, dtype=torch.int32)
    return pos, cnt
