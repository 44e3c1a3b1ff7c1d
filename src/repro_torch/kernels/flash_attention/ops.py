"""Public flash-attention ops.

``flash_attention`` ([B, H, S, D]) is a ``torch.autograd.Function``: its
forward launches kernel K5 on CUDA tensors and takes the plain
``attention_ref`` on CPU tensors (any other device raises); its backward
differentiates ``attention_ref``, as the reference's custom VJP does.
Unlike the reference op, which falls back to ``attention_ref`` for a
ragged non-causal call, the kernel masks keys past Skv itself.
``flash_attention_bshd`` takes the model stack's [B, S, H, D] layout,
which the kernel reads through strides without a transpose copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_bshd"]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    if q.device.type == "cuda":
        return kernel.flash_attention_kernel(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return attention_ref(q, k, v, causal=causal)


class FlashAttention(torch.autograd.Function):
    """Forward on K5; backward through the plain ``attention_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_ref(*inputs, causal=ctx.causal)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention, [B, H, S, D] layout (see flash_attention_bshd for
    the model layout)."""
    return FlashAttention.apply(q, k, v, causal)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Model-stack layout: q [B, S, H, D]; k/v [B, S, KH, D]."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal)
    return out.transpose(1, 2)
