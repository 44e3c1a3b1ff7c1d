"""Kernel K4 (CUDA C++, ``csrc/bloom_probe.cu``): the launch wrapper.

Replaces the reference's Pallas ``bloom_probe_kernel`` / ``_bloom_kernel``
(``repro/kernels/bloom_probe/kernel.py``), which streamed every filter
word past every (query, hash) pair.  Here one thread owns one query,
hashes it k times in uint32 and gathers the k words it needs.  Bound on
the H100: bytes, about one 32-byte sector per (query, hash) pair (see the
source for the design).

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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("bloom_probe")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bloom_probe_launch.argtypes = [p, p, i64, p, i32, i32, p, p]
    lib.bloom_probe_launch.restype = i32
    return lib


def bloom_probe_kernel(words: torch.Tensor, queries: torch.Tensor,
                       coeffs: np.ndarray, s: int) -> torch.Tensor:
    """hits [Q, k] int32: 1 where hash j's bit is set for query q.

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
    a = np.ascontiguousarray(np.asarray(coeffs, np.uint32))
    k = a.shape[0]
    if not 1 <= k <= MAX_HASHES:
        raise ValueError(f"1 to {MAX_HASHES} hashes, got {k}")
    q = queries.shape[0]
    hits = torch.empty((q, k), dtype=torch.int32, device=queries.device)
    if q == 0:
        return hits
    status = _lib().bloom_probe_launch(
        words.data_ptr(), queries.data_ptr(), q,
        a.ctypes.data_as(ctypes.c_void_p), k, s, hits.data_ptr(),
        torch.cuda.current_stream(queries.device).cuda_stream)
    build.check(status, "bloom_probe")
    LAUNCHES.hit()
    return hits
