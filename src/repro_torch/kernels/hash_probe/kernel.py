"""Kernel K3 (CUDA C++, ``csrc/hash_probe.cu``): the launch wrapper.

Replaces the reference's Pallas ``hash_probe_kernel`` / ``_probe_kernel``
(``repro/kernels/hash_probe/kernel.py``), which compared every query with
every bucket block.  Here each query reads only its own bucket row: one
warp owns 32 queries and issues all their row loads (16 bytes a lane)
before any compare.  Bound on the H100: bytes, about
``Q * (CAP * 4 + 16)`` (see the source for the design).  Rows read as
``int4`` when ``cap`` is a multiple of 4 and the table 16-byte aligned,
else as scalars — both inside the kernel.

Multiply-shift family (Dietzfelbinger, as in the paper):
    h(x) = (a * x mod 2^32) >> (32 - s),  buckets = 2^s, a odd.

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

LAUNCHES = counter("hash_probe")

_MASK32 = 0xFFFFFFFF


def mul_shift32(x: torch.Tensor, a: int, s: int) -> torch.Tensor:
    """(a x mod 2^32) >> (32 - s) as int64, x wrapped to uint32.

    torch has no full uint32 arithmetic, so the product is taken modulo
    2^32 in int64 pieces that never overflow: with a = a_hi 2^16 + a_lo,
    a x = x a_lo + (x a_hi mod 2^16) 2^16  (mod 2^32)."""
    xu = x.to(torch.int64) & _MASK32
    a &= _MASK32
    a_lo, a_hi = a & 0xFFFF, a >> 16
    h = (xu * a_lo + (((xu * a_hi) & 0xFFFF) << 16)) & _MASK32
    return h >> (32 - s)


def multiply_shift(x: torch.Tensor, a: int, s: int) -> torch.Tensor:
    """Bucket id in [0, 2^s) (int64) of the 32-bit multiply-shift hash
    (the multiplier forced odd)."""
    return mul_shift32(x, a | 1, s)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("hash_probe")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hash_probe_launch.argtypes = [p, p, i64, p, i64, ctypes.c_uint32,
                                      i32, i32, p, p, p]
    lib.hash_probe_launch.restype = i32
    return lib


def hash_probe_kernel(table_keys: torch.Tensor, table_values: torch.Tensor,
                      queries: torch.Tensor, a: int, s: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, val): the flat slot of each query's first match in its bucket
    row (NOT_FOUND if absent) and the value there (0 if absent)."""
    for t in (table_keys, table_values, queries):
        if t.device.type != "cuda" or not t.is_contiguous() or \
                t.dtype != torch.int32:
            raise ValueError("hash_probe kernel takes contiguous int32 "
                             "CUDA tensors")
        if t.device != queries.device:
            raise ValueError("table and queries must share one device")
    nb, cap = table_keys.shape
    if table_values.shape != table_keys.shape or nb != 1 << s or \
            queries.dim() != 1:
        raise ValueError(f"table must be [2^s, cap] = [{1 << s}, cap] "
                         f"keys and values, queries 1-D")
    if nb * cap >= 1 << 31:
        raise ValueError("hash_probe answers int32 slot positions: the "
                         "table must hold fewer than 2^31 slots")
    vec = cap % 4 == 0 and table_keys.data_ptr() % 16 == 0
    q = queries.shape[0]
    pos = torch.empty(q, dtype=torch.int32, device=queries.device)
    val = torch.empty(q, dtype=torch.int32, device=queries.device)
    if q == 0:
        return pos, val
    status = _lib().hash_probe_launch(
        table_keys.data_ptr(), table_values.data_ptr(), cap,
        queries.data_ptr(), q, a & _MASK32, s, int(vec), pos.data_ptr(),
        val.data_ptr(), torch.cuda.current_stream(queries.device).cuda_stream)
    build.check(status, "hash_probe")
    LAUNCHES.hit()
    return pos, val
