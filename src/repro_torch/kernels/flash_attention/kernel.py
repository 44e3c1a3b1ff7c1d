"""Kernel K5 (CUDA C++, ``csrc/flash_attention.cu``): the launch wrapper.

Replaces the reference's Pallas ``flash_attention_kernel`` /
``_flash_kernel`` (``repro/kernels/flash_attention/kernel.py``): an
online-softmax forward with float32 running state, GQA and causal tile
skipping.  Ragged lengths are masked in the kernel and the inputs are read
through their strides (see the source for the design).  Bound on the H100:
operations, ``4 B H D`` x the (row, key) pairs the mask keeps, at the bf16
tensor-core peak.

Two hand-written variants, chosen by input (:func:`variant`), never one
in place of the other:

* ``"wgmma"``: bf16 with D in :data:`WGMMA_HEAD_DIMS` — tensor cores
  (``wgmma``) for both products, K/V tiles brought in by TMA through an
  mbarrier ring.  TMA needs 16-byte aligned base pointers and strides;
  an input without them raises :class:`ValueError`.
* ``"simt"``: float32, or any other D — scalar float32 products, so the
  float32 path holds 1e-5.

Every launch adds one to the ``flash_attention`` counter and one to its
variant's (``flash_attention_wgmma`` / ``flash_attention_simt``).  The
wrapper takes CUDA tensors only; :mod:`.ops` routes CPU tensors to the
plain version in :mod:`.ref`.
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
#: head dims the tensor-core variant is built for (bf16 only)
WGMMA_HEAD_DIMS = (64, 128)

LAUNCHES = counter("flash_attention")
VARIANT_LAUNCHES = {"wgmma": counter("flash_attention_wgmma"),
                    "simt": counter("flash_attention_simt")}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [i32, p, p, p, p, i32, i32, i32,
                                           i32, i32, i32, p, ctypes.c_float,
                                           i32, p]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_wgmma_launch.argtypes = [p, p, p, p, i32, i32, i32,
                                                 i32, i32, i32, p,
                                                 ctypes.c_float, i32, p]
    lib.flash_attention_wgmma_launch.restype = i32
    lib.flash_attention_wgmma_info.argtypes = [i32, p, p]
    lib.flash_attention_wgmma_info.restype = i32
    return lib


def wgmma_info(head_dim: int) -> dict:
    """Registers a thread (at launch) and dynamic shared memory a block of
    the tensor-core variant built for ``head_dim``."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    build.check(_lib().flash_attention_wgmma_info(
        head_dim, ctypes.byref(regs), ctypes.byref(smem)),
        "flash_attention_wgmma_info")
    return {"registers": regs.value, "smem_bytes": smem.value}


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs for inputs of ``dtype`` and ``head_dim``:
    "wgmma" (tensor cores) for bf16 at D 64 or 128, else "simt"."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _tma_strides(t: torch.Tensor) -> list:
    """The (b, h, s) element strides of ``t`` as TMA takes them: 16-byte
    multiples (a size-1 dimension's stride is never stepped, so any
    multiple stands in for it); raises where TMA cannot read ``t``."""
    unit = 16 // t.element_size()
    if t.data_ptr() % 16:
        raise ValueError("the wgmma flash-attention kernel needs 16-byte "
                         "aligned base pointers (TMA)")
    strides = []
    for i in (0, 1, 2):
        st = t.stride(i)
        if t.shape[i] == 1:
            st = unit
        elif st % unit:
            raise ValueError(f"the wgmma flash-attention kernel needs "
                             f"strides of 16 bytes' multiples (TMA); "
                             f"dimension {i} of {tuple(t.shape)} has stride "
                             f"{st}")
        strides.append(st)
    return strides


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
    kind = variant(q.dtype, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    if kind == "wgmma":
        strides = (ctypes.c_int64 * 12)(
            *[s for t in (q, k, v) for s in _tma_strides(t)],
            *[out.stride(i) for i in (0, 1, 2)])
        status = _lib().flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kh, sq, skv, d, strides, scale, int(causal), stream)
    else:
        strides = (ctypes.c_int64 * 12)(*[t.stride(i)
                                          for t in (q, k, v, out)
                                          for i in (0, 1, 2)])
        status = _lib().flash_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kh, sq, skv, d, strides, scale,
            int(causal), stream)
    build.check(status, f"flash_attention ({kind})")
    LAUNCHES.hit()
    VARIANT_LAUNCHES[kind].hit()
    return out
