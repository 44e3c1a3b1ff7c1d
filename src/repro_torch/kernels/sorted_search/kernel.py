"""Kernel K1 (CUDA C++, ``csrc/sorted_search.cu``): launch wrappers.

Replaces the reference's Pallas ``sorted_search_kernel`` /
``_search_kernel`` (``repro/kernels/sorted_search/kernel.py``): one
thread per query runs a branchless upper-bound binary search over the
sorted keys instead of the TPU's O(N) all-compare count.  Bound on the
H100: ``ceil(log2 N)`` dependent loads per query, the upper levels of
every search served from L2 (see the source for the design).

These wrappers take CUDA tensors only; :mod:`.ops` routes CPU tensors to
the plain versions in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, counter

#: key dtype -> the launcher's dtype code
KEY_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2}
#: value dtypes sorted_get moves (as raw 4- or 8-byte words)
VALUE_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)

LAUNCHES = counter("sorted_search")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("sorted_search")
    lib.sorted_search_launch.argtypes = [_INT, _P, _I64, _P, _I64, _P, _P]
    lib.sorted_search_launch.restype = _INT
    lib.sorted_get_launch.argtypes = [_INT, _INT, _P, _P, _I64, _P, _I64,
                                      _P, _P, _P]
    lib.sorted_get_launch.restype = _INT
    return lib


def _check_inputs(keys: torch.Tensor, queries: torch.Tensor) -> None:
    for t in (keys, queries):
        if t.device.type != "cuda" or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("sorted_search kernel takes contiguous 1-D "
                             "CUDA tensors")
    if keys.device != queries.device:
        raise ValueError("keys and queries must share one device")
    if keys.dtype not in KEY_DTYPES or queries.dtype != keys.dtype:
        raise TypeError(f"keys and queries must share one of "
                        f"{list(KEY_DTYPES)}, got {keys.dtype} and "
                        f"{queries.dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sorted_search_kernel(keys: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """int32 ranks (searchsorted-right, clamped to N) of ``queries`` in
    the ascending ``keys``."""
    _check_inputs(keys, queries)
    ranks = torch.empty(queries.shape[0], dtype=torch.int32,
                        device=queries.device)
    if queries.shape[0] == 0:
        return ranks
    status = _lib().sorted_search_launch(
        KEY_DTYPES[keys.dtype], keys.data_ptr(), keys.shape[0],
        queries.data_ptr(), queries.shape[0], ranks.data_ptr(),
        _stream(queries))
    build.check(status, "sorted_search")
    LAUNCHES.hit()
    return ranks


def sorted_get_kernel(keys: torch.Tensor, values: torch.Tensor,
                      queries: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found mask, values | 0) of point lookups, search and gather in one
    launch."""
    _check_inputs(keys, queries)
    if values.device != keys.device or values.dim() != 1 or \
            not values.is_contiguous() or values.shape[0] != keys.shape[0]:
        raise ValueError("values must be a contiguous 1-D CUDA tensor as "
                         "long as keys")
    if values.dtype not in VALUE_DTYPES:
        raise TypeError(f"values must be one of {VALUE_DTYPES}")
    if keys.shape[0] == 0:
        raise ValueError("sorted_get needs at least one key")
    q = queries.shape[0]
    found = torch.empty(q, dtype=torch.bool, device=queries.device)
    out = torch.empty(q, dtype=values.dtype, device=queries.device)
    if q == 0:
        return found, out
    status = _lib().sorted_get_launch(
        KEY_DTYPES[keys.dtype], values.element_size(), keys.data_ptr(),
        values.data_ptr(), keys.shape[0], queries.data_ptr(), q,
        found.data_ptr(), out.data_ptr(), _stream(queries))
    build.check(status, "sorted_get")
    LAUNCHES.hit()
    return found, out
