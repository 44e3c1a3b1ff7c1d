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

Two hand-written variants of each, chosen by input (:func:`variant` for
the forward, :func:`bwd_variant` for the backward), never one in place of
the other:

* ``"wgmma"`` (both directions): bf16 with D in :data:`WGMMA_HEAD_DIMS` —
  tensor cores (``wgmma``) for every product, tiles brought in by TMA
  through an mbarrier ring.  Tiles are whole 64-column boxes: at D 160 a
  third box whose columns 160-191 TMA fills with zeros, and P V at N 192.
  TMA needs 16-byte aligned base pointers and strides; an input without
  them raises :class:`ValueError`.
  The backward rounds P and dS to bf16 once for their products.
* ``"tf32x3"`` (both directions): float32, or bf16 at any other D —
  every product on the tensor cores (``mma.sync`` m16n8k8, tf32) in the
  3xTF32 split (hi + lo of each operand, three products), which keeps the
  float32 limits (1e-5; the CPU emulations of that arithmetic in
  ``tests/test_torch_flash_numerics.py`` (forward) and
  ``tests/test_torch_flash_backward.py`` hold it).  The forward splits
  each operand once a block: Q as it loads, each K / V tile once into
  fragment records, P in registers.

Every forward adds one to the ``flash_attention`` counter and one to its
variant's (``flash_attention_wgmma`` / ``flash_attention_tf32x3``); every
backward (three kernels: delta, dK/dV, dQ; a fourth, the sum of the dK/dV
pass's partials, where :func:`dkv_splits` splits that pass) one to
``flash_attention_bwd`` and one to ``flash_attention_bwd_wgmma`` /
``flash_attention_bwd_tf32x3``.  The wrappers take CUDA tensors only;
:mod:`.ops` routes CPU tensors to the plain versions in :mod:`.ref`.
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
                    "tf32x3": counter("flash_attention_tf32x3")}
BWD_LAUNCHES = counter("flash_attention_bwd")
BWD_VARIANT_LAUNCHES = {"wgmma": counter("flash_attention_bwd_wgmma"),
                        "tf32x3": counter("flash_attention_bwd_tf32x3")}


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
    # q, k, v, out, lse, dout, dq, dk, dv, scratch (delta, lse in base 2),
    # the dK/dV partials and the split count
    lib.flash_attention_bwd_launch.argtypes = [i32] + [p] * 11 + [
        i32, i32, i32, i32, i32, i32, i32, p, f32, i32, p]
    lib.flash_attention_bwd_wgmma_launch.argtypes = [p] * 11 + [
        i32, i32, i32, i32, i32, i32, i32, p, f32, i32, p]
    lib.flash_attention_wgmma_info.argtypes = [i32, p, p]
    lib.flash_attention_bwd_wgmma_info.argtypes = [i32, i32, p, p]
    lib.flash_attention_bwd_tf32x3_info.argtypes = [i32, i32, p, p]
    lib.flash_attention_tf32x3_info.argtypes = [i32, p, p, p]
    for fn in (lib.flash_attention_launch, lib.flash_attention_wgmma_launch,
               lib.flash_attention_bwd_launch,
               lib.flash_attention_bwd_wgmma_launch,
               lib.flash_attention_wgmma_info,
               lib.flash_attention_tf32x3_info,
               lib.flash_attention_bwd_wgmma_info,
               lib.flash_attention_bwd_tf32x3_info):
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


def fwd_tf32x3_info(head_dim: int) -> dict:
    """Registers a thread, dynamic shared memory a block and local memory
    a thread (spills; 0 when none) of the tf32x3 forward built for
    ``head_dim`` (float32 inputs)."""
    regs, smem, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check(_lib().flash_attention_tf32x3_info(
        head_dim, ctypes.byref(regs), ctypes.byref(smem),
        ctypes.byref(local)), "flash_attention_tf32x3_info")
    return {"registers": regs.value, "smem_bytes": smem.value,
            "local_bytes": local.value}


def _bwd_info(fn, name: str, head_dim: int) -> dict:
    out = {}
    for which, part in enumerate(("dkv", "dq")):
        regs, smem = ctypes.c_int(), ctypes.c_int()
        build.check(fn(head_dim, which, ctypes.byref(regs),
                       ctypes.byref(smem)), name)
        out[part] = {"registers": regs.value, "smem_bytes": smem.value}
    return out


def bwd_wgmma_info(head_dim: int) -> dict:
    """The same for the tensor-core backward's two main kernels, the
    dK/dV pass ("dkv") and the dQ pass ("dq")."""
    return _bwd_info(_lib().flash_attention_bwd_wgmma_info,
                     "flash_attention_bwd_wgmma_info", head_dim)


def bwd_tf32x3_info(head_dim: int) -> dict:
    """The same for the tf32x3 backward's dK/dV and dQ kernels built for
    ``head_dim`` (float32 inputs)."""
    return _bwd_info(_lib().flash_attention_bwd_tf32x3_info,
                     "flash_attention_bwd_tf32x3_info", head_dim)


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel that runs for inputs of ``dtype`` and
    ``head_dim``: "wgmma" (bf16 tensor cores) for bf16 at D 64, 128 or
    160, else "tf32x3" (float32 on the tensor cores)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "tf32x3"


def bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel that runs for inputs of ``dtype`` and
    ``head_dim``: "wgmma" for bf16 at D 64, 128 or 160, else "tf32x3"
    (float32 on the tensor cores): the forward's variant."""
    return variant(dtype, head_dim)


# --- the dK/dV pass's split ------------------------------------------------
#: q rows a step of the dK/dV pass streams (the wgmma variant's; tf32x3
#: streams 32 or 16, so its blocks take more, shorter steps)
DKV_STEP_ROWS = 64


def dkv_keys(head_dim: int) -> int:
    """Keys a dK/dV block owns, in both variants: 128, or 64 above D 128
    (where dV and dK are summed by different warps)."""
    return 64 if head_dim > 128 else 128


def dkv_splits(batch: int, kv_heads: int, group: int, sq: int, skv: int,
               head_dim: int, sms: int) -> int:
    """How many blocks share each KV tile's work in the dK/dV pass.

    A block owns :func:`dkv_keys` keys of one KV head and walks its
    group's q heads over the q tiles (under causal, from the diagonal
    on), so a pass of fewer blocks than the card has SMs (``sms``; a block
    holds an SM) runs one wave whose causal triangle leaves the SMs half
    idle.  There the work of each KV tile is split over the fewest blocks
    ``s`` that make a full wave, each summing float32 partials that one
    more kernel adds in a fixed order; ``s`` never exceeds the heaviest
    tile's steps.  (At qwen2-1.5b's training shape, 128 blocks on 132
    SMs, that is 2: measured on an H100, 2 and 4 beat 3 and 6 by 1-3% in
    bf16 and float32, and 1 is 1.35-1.5x slower.)  Where the grid already
    fills the card, 1: nothing is split and no scratch is used."""
    blocks = batch * kv_heads * -(-skv // dkv_keys(head_dim))
    if blocks >= sms:
        return 1
    steps = group * -(-sq // DKV_STEP_ROWS)
    return max(1, min(-(-sms // blocks), steps))


def dkv_work(batch: int, kv_heads: int, group: int, sq: int, skv: int,
             keys: int, rows: int, causal: bool, splits: int) -> list:
    """The dK/dV pass's blocks in launch order, as the kernels walk them:
    for each (KV tile y, then b * KH + KV head, then split j) the list of
    (q head, q tile) steps that block sums.  KV tile y owns keys y * keys
    .. y * keys + keys - 1; its steps are its group's q heads x its q
    tiles of ``rows`` rows (under causal, from the one holding its first
    key on), in order, split into ``splits`` runs, the longer first."""
    n_q = -(-sq // rows)
    blocks = []
    for y in range(-(-skv // keys)):
        qt0 = min(y * keys // rows, n_q) if causal else 0
        per = n_q - qt0
        total = group * per
        base, extra = divmod(total, splits)
        for x in range(splits * batch * kv_heads):
            j, bkv = x % splits, x // splits
            b, kvh = divmod(bkv, kv_heads)
            begin = j * base + min(j, extra)
            end = begin + base + (1 if j < extra else 0)
            blocks.append({"b": b, "kv_head": kvh, "key_tile": y,
                           "split": j,
                           "steps": [(kvh * group + t // per, qt0 + t % per)
                                     for t in range(begin, end)]})
    return blocks


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    kind = bwd_variant(q.dtype, d)
    if out.stride(-1) != 1:
        out = out.contiguous()
    if not _readable(dout, kind):
        dout = dout.contiguous()
    lse = lse.contiguous()
    # delta and lse in base-2 units, [B * H, Sq rounded up to 64] each
    sq_pad = -(-sq // 64) * 64
    scratch = torch.empty(2 * b * h * sq_pad, dtype=torch.float32,
                          device=q.device)
    # the dK/dV pass's float32 partials, where it is split
    splits = dkv_splits(b, kh, h // kh, sq, skv, d,
                        _sm_count(q.device.index if q.device.index is not None
                                  else torch.cuda.current_device()))
    part = torch.empty(2 * splits * b * kh * skv * d if splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk, dv,
                                   scratch)] + [
        part.data_ptr() if splits > 1 else None, splits]
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
