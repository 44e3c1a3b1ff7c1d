"""Kernel K5 (CUDA C++, ``csrc/flash_attention.cu``): the launch wrapper.

Replaces the reference's Pallas ``flash_attention_kernel`` /
``_flash_kernel`` (``repro/kernels/flash_attention/kernel.py``): an
online-softmax forward with float32 running state, GQA and causal tile
skipping, which also writes each row's log-sum-exp; and the reference
op's backward (``_bwd``, ``repro/kernels/flash_attention/ops.py:66``, an
XLA pullback of ``attention_ref`` there), here a hand-written kernel from
the saved output and log-sum-exp.  Ragged lengths are masked in the
kernels and the inputs are read through their strides (see the source
for the design).  Bound on the H100: operations, ``4 B H D`` (forward)
and ``10 B H D`` (backward) x the (row, key) pairs the mask keeps, at the
bf16 tensor-core peak.

Two hand-written variants of each, chosen by input (:func:`variant`),
never one in place of the other:

* ``"wgmma"``: bf16 with D in :data:`WGMMA_HEAD_DIMS` — tensor cores
  (``wgmma``) for both products, K/V tiles brought in by TMA through an
  mbarrier ring.  Tiles are whole 64-column boxes: at D 160 a third box
  whose columns 160-191 TMA fills with zeros, and P V at N 192.  TMA
  needs 16-byte aligned base pointers and strides; an input without
  them raises :class:`ValueError`.
  The backward rounds P and dS to bf16 once for their products.
* ``"simt"``: float32, or any other D — scalar float32 products, so the
  float32 path holds 1e-5.

Every forward adds one to the ``flash_attention`` counter and one to its
variant's (``flash_attention_wgmma`` / ``flash_attention_simt``); every
backward (three kernels: delta, dK/dV, dQ) one to ``flash_attention_bwd``
and one to ``flash_attention_bwd_wgmma`` / ``flash_attention_bwd_simt``.
The wrappers take CUDA tensors only; :mod:`.ops` routes CPU tensors to
the plain versions in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build, counter

#: input dtype -> the launcher's dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: head dims the tensor-core variant is built for (bf16 only)
WGMMA_HEAD_DIMS = (64, 128, 160)

LAUNCHES = counter("flash_attention")
VARIANT_LAUNCHES = {"wgmma": counter("flash_attention_wgmma"),
                    "simt": counter("flash_attention_simt")}
BWD_LAUNCHES = counter("flash_attention_bwd")
BWD_VARIANT_LAUNCHES = {"wgmma": counter("flash_attention_bwd_wgmma"),
                        "simt": counter("flash_attention_bwd_simt")}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.c_float
    lib.flash_attention_launch.argtypes = [i32, p, p, p, p, p, i32, i32, i32,
                                           i32, i32, i32, p, f32, i32, p]
    lib.flash_attention_wgmma_launch.argtypes = [p, p, p, p, p, i32, i32,
                                                 i32, i32, i32, i32, p, f32,
                                                 i32, p]
    # q, k, v, out, lse, dout, dq, dk, dv, scratch (delta, lse in base 2)
    lib.flash_attention_bwd_launch.argtypes = [i32] + [p] * 10 + [
        i32, i32, i32, i32, i32, i32, p, f32, i32, p]
    lib.flash_attention_bwd_wgmma_launch.argtypes = [p] * 10 + [
        i32, i32, i32, i32, i32, i32, p, f32, i32, p]
    lib.flash_attention_wgmma_info.argtypes = [i32, p, p]
    lib.flash_attention_bwd_wgmma_info.argtypes = [i32, i32, p, p]
    for fn in (lib.flash_attention_launch, lib.flash_attention_wgmma_launch,
               lib.flash_attention_bwd_launch,
               lib.flash_attention_bwd_wgmma_launch,
               lib.flash_attention_wgmma_info,
               lib.flash_attention_bwd_wgmma_info):
        fn.restype = i32
    return lib


def wgmma_info(head_dim: int) -> dict:
    """Registers a thread (at launch) and dynamic shared memory a block of
    the tensor-core variant built for ``head_dim``."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    build.check(_lib().flash_attention_wgmma_info(
        head_dim, ctypes.byref(regs), ctypes.byref(smem)),
        "flash_attention_wgmma_info")
    return {"registers": regs.value, "smem_bytes": smem.value}


def bwd_wgmma_info(head_dim: int) -> dict:
    """The same for the tensor-core backward's two main kernels, the
    dK/dV pass ("dkv") and the dQ pass ("dq")."""
    out = {}
    for which, name in enumerate(("dkv", "dq")):
        regs, smem = ctypes.c_int(), ctypes.c_int()
        build.check(_lib().flash_attention_bwd_wgmma_info(
            head_dim, which, ctypes.byref(regs), ctypes.byref(smem)),
            "flash_attention_bwd_wgmma_info")
        out[name] = {"registers": regs.value, "smem_bytes": smem.value}
    return out


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs for inputs of ``dtype`` and ``head_dim``:
    "wgmma" (tensor cores) for bf16 at D 64, 128 or 160, else "simt"."""
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


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> None:
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


def _strides(*ts: torch.Tensor) -> list:
    return [t.stride(i) for t in ts for i in (0, 1, 2)]


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(D)) v.  q: [B, H, Sq, D]; k/v: [B, KH, Skv, D]
    with H % KH == 0, any strides with D contiguous (a transposed
    [B, S, H, D] view is read in place).  Returns the output, [B, H, Sq,
    D] in q's dtype laid out like q, and each row's log-sum-exp of its
    scaled scores, float32 [B, H, Sq] (natural log; -inf where no key is
    kept), which the backward takes."""
    _check_inputs(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    out = torch.empty_like(q)          # q's layout (D contiguous)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    if skv == 0:
        return out.zero_(), lse.fill_(float("-inf"))
    kind = variant(q.dtype, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    if kind == "wgmma":
        strides = (ctypes.c_int64 * 12)(
            *[s for t in (q, k, v) for s in _tma_strides(t)],
            *_strides(out))
        status = _lib().flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, k.shape[1], sq, skv, d, strides, scale,
            int(causal), stream)
    else:
        strides = (ctypes.c_int64 * 12)(*_strides(q, k, v, out))
        status = _lib().flash_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, k.shape[1], sq, skv, d,
            strides, scale, int(causal), stream)
    build.check(status, f"flash_attention ({kind})")
    LAUNCHES.hit()
    VARIANT_LAUNCHES[kind].hit()
    return out, lse


def _readable(t: torch.Tensor, kind: str) -> bool:
    """Whether the ``kind`` variant reads ``t`` in place: D contiguous, no
    stride 0 over a dimension of several entries (an expanded gradient),
    and for "wgmma" what TMA needs."""
    if t.stride(-1) != 1 or any(t.stride(i) == 0 and t.shape[i] > 1
                                for i in range(3)):
        return False
    try:
        return kind != "wgmma" or bool(_tma_strides(t))
    except ValueError:
        return False


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor,
                               causal: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_kernel` from its ``out`` and
    ``lse`` and the output's gradient ``dout`` (q's shape and dtype, any
    strides).  dq, dk and dv are laid out like q, k and v.  A ``dout``
    whose last dimension is not contiguous, or that TMA cannot read (the
    tensor-core variant; an expanded gradient's stride 0, say), is copied
    to a contiguous tensor first; q, k and v are read as the forward reads
    them, and raise as it does."""
    _check_inputs(q, k, v)
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be q's "
                             f"shape and dtype on q's device")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or \
            lse.device != q.device:
        raise ValueError(f"lse must be float32 [B, H, Sq], got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    kind = variant(q.dtype, d)
    if out.stride(-1) != 1:
        out = out.contiguous()
    if not _readable(dout, kind):
        dout = dout.contiguous()
    lse = lse.contiguous()
    # delta and lse in base-2 units, [B * H, Sq rounded up to 64] each
    sq_pad = -(-sq // 64) * 64
    scratch = torch.empty(2 * b * h * sq_pad, dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk, dv,
                                   scratch)]
    if kind == "wgmma":
        strides = (ctypes.c_int64 * 24)(
            *[s for t in (q, k, v, dout) for s in _tma_strides(t)],
            *_strides(out, dq, dk, dv))
        status = _lib().flash_attention_bwd_wgmma_launch(
            *ptrs, b, h, kh, sq, skv, d, strides, scale, int(causal), stream)
    else:
        strides = (ctypes.c_int64 * 24)(*_strides(q, k, v, dout, out, dq,
                                                  dk, dv))
        status = _lib().flash_attention_bwd_launch(
            DTYPES[q.dtype], *ptrs, b, h, kh, sq, skv, d, strides, scale,
            int(causal), stream)
    build.check(status, f"flash_attention_bwd ({kind})")
    BWD_LAUNCHES.hit()
    BWD_VARIANT_LAUNCHES[kind].hit()
    return dq, dk, dv
