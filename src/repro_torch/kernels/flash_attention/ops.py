"""Public flash-attention ops.

``flash_attention`` ([B, H, S, D]) is the custom op
``repro_torch::flash_attention_fwd``: its forward launches kernel K5 on
CUDA tensors and takes the plain ``attention_ref`` on CPU tensors (any
other device with storage raises); its backward differentiates
``attention_ref``, as the reference's custom VJP does.  Being a
``torch.library`` op, it has a fake implementation (the output's shape,
dtype and layout), so a step runs on fake or meta tensors (the dry
run's), and a flop formula, ``4 B H D`` x the (query, key) pairs the
mask keeps, so ``FlopCounterMode`` and the dry run's counter count the
kernel they cannot see inside.  Unlike the reference op, which falls
back to ``attention_ref`` for a ragged non-causal call, the kernel masks
keys past Skv itself.  ``flash_attention_bshd`` takes the model stack's
[B, S, H, D] layout, which the kernel reads through strides without a
transpose copy.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_bshd",
           "kept_pairs"]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    if q.device.type == "cuda":
        return kernel.flash_attention_kernel(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return attention_ref(q, k, v, causal=causal)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """Forward on K5 (CUDA tensors) or its plain version (CPU)."""
    return _forward(q, k, v, causal)


@flash_attention_fwd.register_fake
def _fake(q, k, v, causal):
    return torch.empty_like(q)


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.causal = causal
    ctx.save_for_backward(q, k, v)


def _backward(ctx, grad):
    q, k, v = ctx.saved_tensors
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*inputs, causal=ctx.causal)
        grads = torch.autograd.grad(out, inputs, grad)
    return (*grads, None)


flash_attention_fwd.register_autograd(_backward,
                                      setup_context=_setup_context)


def kept_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs the mask keeps: every pair, or under the
    top-left aligned causal mask (row >= col) min(row + 1, Skv) a row."""
    if not causal:
        return sq * skv
    full = max(sq - skv, 0)
    tri = min(sq, skv)
    return tri * (tri + 1) // 2 + full * skv


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    b, h, sq, d = q_shape
    return 4 * b * h * d * kept_pairs(sq, k_shape[2], causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention, [B, H, S, D] layout (see flash_attention_bshd for
    the model layout)."""
    return flash_attention_fwd(q, k, v, causal)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Model-stack layout: q [B, S, H, D]; k/v [B, S, KH, D]."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal)
    return out.transpose(1, 2)
