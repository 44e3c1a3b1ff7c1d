"""Kernel K2 (CUDA C++, ``csrc/scan_filter.cu``): the launch wrapper.

Replaces the reference's Pallas ``scan_filter_kernel`` / ``_scan_kernel``
(``repro/kernels/scan_filter/kernel.py``), whose sequential key-block
grid axis carried a running min and count.  Here each thread keeps its
queries' running first match and count in registers over a key range
staged through shared memory, and key ranges split across blocks combine
with int32 ``atomicMin`` / ``atomicAdd``, which are exact in any order.
Bound on the H100: integer operations, N * Q pairs (see the source).

The wrapper takes CUDA tensors only; :mod:`.ops` routes CPU tensors to
the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, counter

NOT_FOUND = 2147483647  # int32 max

#: key dtype -> the launcher's dtype code
KEY_DTYPES = {torch.int32: 0, torch.float32: 1}

LAUNCHES = counter("scan_filter")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("scan_filter")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.scan_filter_launch.argtypes = [i32, p, i64, p, p, p, i64, p, p, p]
    lib.scan_filter_launch.restype = i32
    return lib


def scan_filter_kernel(keys: torch.Tensor, queries: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, count): pos[q] = first index with keys[i] == queries[q]
    (NOT_FOUND if absent); count[q] = #{i : lo[q] <= keys[i] < hi[q]}."""
    for t in (keys, queries, lo, hi):
        if t.device.type != "cuda" or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("scan_filter kernel takes contiguous 1-D CUDA "
                             "tensors")
        if t.device != keys.device:
            raise ValueError("keys, queries, lo and hi must share one "
                             "device")
        if t.dtype != keys.dtype:
            raise TypeError("keys, queries, lo and hi must share one dtype")
    if keys.dtype not in KEY_DTYPES:
        raise TypeError(f"scan_filter kernel takes {list(KEY_DTYPES)} keys, "
                        f"got {keys.dtype}")
    n, q = keys.shape[0], queries.shape[0]
    if lo.shape[0] != q or hi.shape[0] != q:
        raise ValueError("queries, lo and hi must have one length")
    if n >= NOT_FOUND:
        raise ValueError(f"at most {NOT_FOUND - 1} keys (int32 positions)")
    pos = torch.full((q,), NOT_FOUND, dtype=torch.int32, device=keys.device)
    cnt = torch.zeros((q,), dtype=torch.int32, device=keys.device)
    if q == 0 or n == 0:
        return pos, cnt
    status = _lib().scan_filter_launch(
        KEY_DTYPES[keys.dtype], keys.data_ptr(), n, queries.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), q, pos.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(status, "scan_filter")
    LAUNCHES.hit()
    return pos, cnt
