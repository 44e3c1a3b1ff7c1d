"""Plain versions of kernel K3 and the table builder.

``build_table`` is the reference's ``hash_probe/ref.py:19`` vectorized: a
stable sort by bucket keeps each bucket's insertion order, and entries
past ``cap`` in a bucket are dropped — the same table, without a Python
loop over 2^24 keys.  ``hash_probe_ref`` is the plain PyTorch probe: a
gather of each query's bucket row, a compare, and the first match.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.hash_probe.kernel import (NOT_FOUND,
                                                   multiply_shift)

EMPTY_KEY = np.int32(-2147483648)  # sentinel: never a valid key


def multiply_shift_np(x: np.ndarray, a: int, s: int) -> np.ndarray:
    """Bucket ids in [0, 2^s) of the 32-bit multiply-shift hash."""
    h = np.asarray(x).astype(np.uint32) * np.uint32(a | 1)
    return (h.astype(np.uint64) >> np.uint64(32 - s)).astype(np.int64)


def build_table(keys: np.ndarray, values: np.ndarray, s: int, a: int,
                cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bucket-major [2^s, cap] int32 table; overflowing entries are
    dropped (a fixed-capacity bucket; callers size cap for the load
    factor)."""
    nb = 1 << s
    tkeys = np.full((nb, cap), EMPTY_KEY, np.int32)
    tvals = np.zeros((nb, cap), np.int32)
    keys = np.asarray(keys)
    values = np.asarray(values)
    buckets = multiply_shift_np(keys, a, s)
    order = np.argsort(buckets, kind="stable")
    b_sorted = buckets[order]
    slot = np.arange(len(order)) - np.searchsorted(b_sorted, b_sorted,
                                                   side="left")
    keep = slot < cap
    rows, cols = b_sorted[keep], slot[keep]
    tkeys[rows, cols] = keys[order][keep].astype(np.int32)
    tvals[rows, cols] = values[order][keep].astype(np.int32)
    return tkeys, tvals


def hash_probe_ref(table_keys: torch.Tensor, table_values: torch.Tensor,
                   queries: torch.Tensor, a: int, s: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat slot pos | NOT_FOUND, value | 0) per query, int32."""
    cap = table_keys.shape[1]
    bucket = multiply_shift(queries, a, s)
    rows = table_keys[bucket]                         # [Q, cap]
    match = rows == queries[:, None]
    hit = match.any(dim=1)
    first = torch.argmax(match.to(torch.int8), dim=1)  # first True slot
    flat = bucket * cap + first
    pos = torch.where(hit, flat, torch.full_like(flat, NOT_FOUND))
    val = torch.where(hit, table_values.reshape(-1)[flat],
                      torch.zeros((), dtype=table_values.dtype,
                                  device=table_values.device))
    return pos.to(torch.int32), val
