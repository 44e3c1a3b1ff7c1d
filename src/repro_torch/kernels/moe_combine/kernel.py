"""The MoE combine (CUDA C++, ``csrc/moe_combine.cu``): the launch wrapper.

Replaces no Pallas kernel: the reference's combine is XLA's scatter-add
(``.at[].add``, ``repro/models/moe.py:92-95``), which the port ran as a
bf16 ``index_add_`` over every capacity slot.  Here each token gathers the
rows of the slots that took it and sums them once in float32, in the
order of its top-k list, so no padding slot and no dropped assignment is
read and no atomic is needed.  Bound on the H100: bytes, about the kept
rows read, the output written and a few bytes of indices and gates a
token (:func:`bytes_needed`); 16-byte loads, eight a thread in flight
(see the source for the design).  One call is a memset of the slot map
and two kernels, counted once on ``moe_combine``.

The wrapper takes CUDA tensors only; :mod:`.ops` routes CPU tensors to
the plain version in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counter

LAUNCHES = counter("moe_combine")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: 16-byte row loads a thread keeps in flight (``kLoads`` in the source)
LOADS = 8


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("moe_combine")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.moe_combine_launch.argtypes = [p, i32, p, p, p, p, i64, i32, i32,
                                       i32, i32, i32, p, p, p]
    lib.moe_combine_launch.restype = i32
    return lib


def vectors_a_thread(k: int, d: int, dtype: torch.dtype) -> int:
    """The 16-byte vectors of a row one thread owns, for top-``k`` and
    rows of ``d`` elements of ``dtype``: ``LOADS / k`` rounded down to a
    power of two, halved until it divides the row's vectors, so that a
    thread keeps up to ``LOADS`` row loads in flight however small k is."""
    vecs = d * dtype.itemsize // 16
    r = 1
    while 2 * r <= LOADS // min(k, LOADS):
        r *= 2
    while vecs % r:
        r //= 2
    return r


def _check(out: torch.Tensor, combine_w: torch.Tensor,
           gate_idx: torch.Tensor, token_ids: torch.Tensor,
           gathered_mask: torch.Tensor) -> None:
    """Raise on what the kernel does not take (device, dtype, layout,
    shape)."""
    dev = out.device
    if dev.type != "cuda":
        raise ValueError("the moe_combine kernel takes CUDA tensors")
    want = ((out, tuple(_DTYPES), "out"),
            (combine_w, (torch.float32,), "combine_w"),
            (gate_idx, (torch.int64,), "gate_idx"),
            (token_ids, (torch.int64,), "token_ids"),
            (gathered_mask, (torch.float32,), "gathered_mask"))
    for x, dtypes, name in want:
        if x.device != dev or not x.is_contiguous() or x.dtype not in dtypes:
            raise ValueError(f"moe_combine: {name} must be a contiguous "
                             f"{' or '.join(map(str, dtypes))} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    if out.dim() != 3:
        raise ValueError(f"moe_combine: out must be [E, C, D], got "
                         f"{tuple(out.shape)}")
    e, c, d = out.shape
    t, k = gate_idx.shape if gate_idx.dim() == 2 else (-1, -1)
    if (tuple(combine_w.shape) != (t, e) or k < 1 or
            tuple(token_ids.shape) != (e, c) or
            tuple(gathered_mask.shape) != (e, c)):
        raise ValueError(
            f"moe_combine: shapes out {tuple(out.shape)}, combine_w "
            f"{tuple(combine_w.shape)}, gate_idx {tuple(gate_idx.shape)}, "
            f"token_ids {tuple(token_ids.shape)}, gathered_mask "
            f"{tuple(gathered_mask.shape)} do not agree ([E, C, D], [T, E], "
            f"[T, k], [E, C], [E, C])")
    if d < 8 or d % 8:
        raise ValueError(f"moe_combine reads rows in 16-byte vectors: D "
                         f"must be a multiple of 8, got {d}")
    if e * c >= 1 << 31 or t * k >= 1 << 31:
        raise ValueError("moe_combine indexes slots and the slot map in "
                         "int32: E C and T k must be under 2^31")
    if out.data_ptr() % 16:
        raise ValueError("moe_combine: out must be 16-byte aligned")


def moe_combine_kernel(out: torch.Tensor, combine_w: torch.Tensor,
                       gate_idx: torch.Tensor, token_ids: torch.Tensor,
                       gathered_mask: torch.Tensor) -> torch.Tensor:
    """y [T, D] in ``out``'s dtype: y[t] = sum over j < k of
    combine_w[t, e_j] out[e_j, s] where slot s of expert e_j = gate_idx[t,
    j] holds t, summed in float32 in the order j = 0..k-1; an assignment
    no slot took adds nothing."""
    _check(out, combine_w, gate_idx, token_ids, gathered_mask)
    e, c, d = out.shape
    t, k = gate_idx.shape
    y = torch.empty((t, d), dtype=out.dtype, device=out.device)
    if t == 0:
        return y
    slot_map = torch.empty((t, k), dtype=torch.int32, device=out.device)
    status = _lib().moe_combine_launch(
        out.data_ptr(), _DTYPES[out.dtype], combine_w.data_ptr(),
        gate_idx.data_ptr(), token_ids.data_ptr(), gathered_mask.data_ptr(),
        t, e, c, d, k, vectors_a_thread(k, d, out.dtype),
        slot_map.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    build.check(status, "moe_combine")
    LAUNCHES.hit()
    return y


def bytes_needed(d: int, dtype: torch.dtype, n_tokens: int, k: int,
                 n_slots: int, kept: int) -> int:
    """The bytes the combine's inputs and output need, each read or written
    once: the kept rows and the output rows, each kept assignment's gate,
    every token's top-k list and every slot's token id and mask."""
    size = dtype.itemsize
    return (kept * d * size + n_tokens * d * size + kept * 4 +
            n_tokens * k * 8 + n_slots * (8 + 4))
