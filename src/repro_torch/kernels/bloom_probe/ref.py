"""Plain versions of kernel K4, and the filter builder.

``_hashes`` and ``build_filter`` are the reference's numpy functions
(``repro/kernels/bloom_probe/ref.py``) as they are: the filter is built on
the host.  ``bloom_hits_ref`` is the plain PyTorch version of the kernel
(``hits [Q, k]``, 1 where hash j's bit is set for query q) and
``bloom_probe_ref`` reduces it to membership, as the reference's oracle
returns it.  Filter words travel as int32 tensors holding the uint32 bits
(torch has no full uint32 arithmetic); the 32-bit products are taken in
int64 16-bit halves (``hash_probe.kernel.mul_shift32``), with each
multiplier as given, as the reference's bloom hashes take them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.hash_probe.kernel import mul_shift32


def _hashes(x: np.ndarray, coeffs: np.ndarray, s: int) -> np.ndarray:
    """[len(x), k] bit positions."""
    xu = x.astype(np.uint32)
    return ((xu[:, None] * coeffs[None, :].astype(np.uint32)) >>
            np.uint32(32 - s)).astype(np.int64)


def build_filter(keys: np.ndarray, coeffs: np.ndarray, s: int) -> np.ndarray:
    """uint32 word array of a bloom filter with 2^s bits."""
    words = np.zeros((1 << s) // 32, np.uint32)
    hv = _hashes(np.asarray(keys), coeffs, s).reshape(-1)
    np.bitwise_or.at(words, hv >> 5, np.uint32(1) << (hv & 31).astype(np.uint32))
    return words


def bloom_hits_ref(words: torch.Tensor, queries: torch.Tensor,
                   coeffs: np.ndarray, s: int) -> torch.Tensor:
    """hits [Q, k] int32: 1 where bit h_j(q) of the filter is set.

    ``words`` holds the filter's uint32 words as int32 (any device);
    ``coeffs`` the k odd multipliers."""
    hv = torch.stack([mul_shift32(queries, int(a), s)
                      for a in np.asarray(coeffs)], dim=1)      # [Q, k]
    w = words.to(torch.int64)[hv >> 5] & 0xFFFFFFFF
    return ((w >> (hv & 31)) & 1).to(torch.int32)


def bloom_probe_ref(words: torch.Tensor, queries: torch.Tensor,
                    coeffs: np.ndarray, s: int) -> torch.Tensor:
    """member mask [Q]: True iff every hash's bit is set."""
    return (bloom_hits_ref(words, queries, coeffs, s) == 1).all(dim=1)
