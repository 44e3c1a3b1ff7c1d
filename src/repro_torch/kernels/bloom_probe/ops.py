"""Public bloom-probe op: membership of queries in a bloom filter.

CUDA tensors launch kernel K4 (:mod:`.kernel`); CPU tensors take the
plain version (:mod:`.ref`); any other device raises.  ``build_filter``
(numpy, on the host) makes the filter both take.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.kernels.bloom_probe import kernel, ref
from repro_torch.kernels.bloom_probe.ref import build_filter

__all__ = ["DEFAULT_COEFFS", "bloom_hits", "bloom_probe", "build_filter",
           "filter_words"]

#: deterministic odd multipliers (the paper draws them randomly per run)
DEFAULT_COEFFS = np.array([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                           0x165667B1], np.uint32) | np.uint32(1)


def filter_words(words: Union[np.ndarray, torch.Tensor],
                 device=None) -> torch.Tensor:
    """The filter's uint32 words as an int32 tensor of the same bits
    (``device`` only for a numpy array)."""
    if isinstance(words, torch.Tensor):
        return words.view(torch.int32) if words.dtype == torch.uint32 \
            else words
    arr = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
    return torch.as_tensor(arr, device=device)


def _probe(words, queries: torch.Tensor, s: int, num_hashes: int,
           mask: bool) -> torch.Tensor:
    coeffs = DEFAULT_COEFFS[:num_hashes]
    words = filter_words(words)
    if queries.device.type == "cuda":
        return kernel.bloom_probe_kernel(words, queries, coeffs, s, mask=mask)
    if queries.device.type != "cpu":
        raise ValueError(f"bloom_probe runs on cpu or cuda, not "
                         f"{queries.device}")
    if mask:
        return ref.bloom_probe_ref(words, queries, coeffs, s)
    return ref.bloom_hits_ref(words, queries, coeffs, s)


def bloom_hits(words: torch.Tensor, queries: torch.Tensor, s: int,
               num_hashes: int = 2) -> torch.Tensor:
    """hits [Q, k]: 1 where hash j's bit is set for query q."""
    return _probe(words, queries, s, num_hashes, mask=False)


def bloom_probe(words: torch.Tensor, queries: torch.Tensor, s: int,
                num_hashes: int = 2) -> torch.Tensor:
    """Membership mask for ``queries`` against a 2^s-bit bloom filter (on
    a CUDA tensor, one launch of K4's mask variant)."""
    return _probe(words, queries, s, num_hashes, mask=True)
