"""Kernel K5 (CUDA C++, ``csrc/flash_attention.cu``): the launch wrapper.

Replaces the reference's Pallas ``flash_attention_kernel`` /
``_flash_kernel`` (``repro/kernels/flash_attention/kernel.py``): an
online-softmax forward with float32 running state, GQA and causal tile
skipping.  Here one block owns one (batch * head, 64-row q tile) and
streams K and V tiles through shared memory; ragged lengths are masked
in the kernel and the inputs are read through their strides (see the
source for the design).  Bound on the H100: operations,
``4 B H Sq Skv D`` (halved when causal) at the bf16 tensor-core peak.

The wrapper takes CUDA tensors only; :mod:`.ops` routes CPU tensors to
the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, counter

#: input dtype -> the launcher's dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

LAUNCHES = counter("flash_attention")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [i32, p, p, p, p, i32, i32, i32,
                                           i32, i32, i32, p, ctypes.c_float,
                                           i32, p]
    lib.flash_attention_launch.restype = i32
    return lib


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True
                           ) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v.  q: [B, H, Sq, D]; k/v: [B, KH, Skv, D]
    with H % KH == 0, any strides with D contiguous (a transposed
    [B, S, H, D] view is read in place).  Returns [B, H, Sq, D] in q's
    dtype, laid out like q."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError("flash_attention kernel takes 4-D CUDA tensors "
                             "with a contiguous last dimension")
        if t.device != q.device:
            raise ValueError("q, k and v must share one device")
        if t.dtype != q.dtype:
            raise TypeError("q, k and v must share one dtype")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes {list(DTYPES)}, got "
                        f"{q.dtype}")
    b, h, sq, d = q.shape
    bk, kh, skv, dk = k.shape
    if bk != b or dk != d or v.shape != k.shape or kh < 1 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not fit [B, H, Sq, D] / [B, KH, Skv, D], "
                         f"H % KH == 0")
    if not 1 <= d <= MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"head dim 1..{MAX_HEAD_DIM} and B*H <= 65535")
    out = torch.empty_like(q)          # q's layout (D contiguous)
    if q.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    strides = (ctypes.c_int64 * 12)(*[t.stride(i) for t in (q, k, v, out)
                                      for i in (0, 1, 2)])
    status = _lib().flash_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, kh, sq, skv, d, strides, 1.0 / math.sqrt(d),
        int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "flash_attention")
    LAUNCHES.hit()
    return out
