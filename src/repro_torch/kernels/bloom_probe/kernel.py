"""Kernel K4 (CUDA C++, ``csrc/bloom_probe.cu``): the launch wrapper.

Replaces the reference's Pallas ``bloom_probe_kernel`` / ``_bloom_kernel``
(``repro/kernels/bloom_probe/kernel.py``), which streamed every filter
word past every (query, hash) pair.  Here one thread owns one query,
hashes it k times in uint32 and gathers the k words it needs.  Bound on
the H100: bytes, about one 32-byte sector per (query, hash) pair (see the
source for the design).  One launch writes either the ``[Q, k]`` hits or,
with ``mask=True``, the ``[Q]`` membership mask (counted on
``bloom_probe_mask``, the hits on ``bloom_probe``).

Hash family: h_j(x) = (a_j * x mod 2^32) >> (32 - s) over 2^s bits.

The wrapper takes CUDA tensors only; :mod:`.ops` routes CPU tensors to
the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, counter

#: most hashes one launch takes (the multipliers travel in the kernel's
#: parameters)
MAX_HASHES = 8

LAUNCHES = counter("bloom_probe")
MASK_LAUNCHES = counter("bloom_probe_mask")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("bloom_probe")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bloom_probe_launch.argtypes = [p, p, i64, p, i32, i32, i32, p, p]
    lib.bloom_probe_launch.restype = i32
    return lib


@functools.lru_cache(maxsize=64)
def _multipliers(coeffs: tuple) -> ctypes.Array:
    """The k multipliers as the launcher's uint32 array, built once."""
    if not 1 <= len(coeffs) <= MAX_HASHES:
        raise ValueError(f"1 to {MAX_HASHES} hashes, got {len(coeffs)}")
    return (ctypes.c_uint32 * len(coeffs))(*coeffs)


def bloom_probe_kernel(words: torch.Tensor, queries: torch.Tensor,
                       coeffs: np.ndarray, s: int,
                       mask: bool = False) -> torch.Tensor:
    """hits [Q, k] int32: 1 where hash j's bit is set for query q; with
    ``mask``, the membership mask [Q] (bool: every bit set) instead.

    ``words``: the 2^s / 32 filter words (int32 or uint32 bits),
    ``queries``: int32, both contiguous on one CUDA device; ``coeffs``:
    the k uint32 multipliers."""
    for t in (words, queries):
        if t.device.type != "cuda" or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("bloom_probe kernel takes contiguous 1-D CUDA "
                             "tensors")
    if words.device != queries.device:
        raise ValueError("words and queries must share one device")
    if words.dtype not in (torch.int32, torch.uint32) or \
            queries.dtype != torch.int32:
        raise TypeError("bloom_probe kernel takes 32-bit words and int32 "
                        "queries")
    if not 5 <= s <= 32 or words.shape[0] != (1 << s) // 32:
        raise ValueError(f"a 2^{s}-bit filter has {(1 << s) // 32} words, "
                         f"got {words.shape[0]}")
    a = _multipliers(tuple(np.asarray(coeffs, np.uint32).tolist()))
    k = len(a)
    q = queries.shape[0]
    out = torch.empty((q,) if mask else (q, k),
                      dtype=torch.bool if mask else torch.int32,
                      device=queries.device)
    if q == 0:
        return out
    status = _lib().bloom_probe_launch(
        words.data_ptr(), queries.data_ptr(), q, a, k, s, int(mask),
        out.data_ptr(), torch.cuda.current_stream(queries.device).cuda_stream)
    build.check(status, "bloom_probe")
    (MASK_LAUNCHES if mask else LAUNCHES).hit()
    return out
