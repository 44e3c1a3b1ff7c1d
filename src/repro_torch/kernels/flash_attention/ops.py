"""Public flash-attention ops.

``flash_attention`` ([B, H, S, D]) is two custom ops.
``repro_torch::flash_attention_fwd`` returns the output and each row's
log-sum-exp: on CUDA tensors it launches kernel K5, on CPU tensors it
takes the plain ``attention_ref`` and ``attention_lse_ref`` (any other
device with storage raises).  Its backward is
``repro_torch::flash_attention_bwd``, from the saved output and
log-sum-exp: K5's backward kernel on CUDA tensors, the plain
``attention_bwd_ref`` on CPU tensors; the reference's custom VJP computes
the same gradients as XLA's pullback of ``attention_ref``.  Being
``torch.library`` ops, both have fake implementations (the outputs'
shapes, dtypes and layouts), so a step runs on fake or meta tensors (the
dry run's), and flop formulas, ``4 B H D`` (forward: two products) and
``10 B H D`` (backward: five) x the (query, key) pairs the mask keeps, so
``FlopCounterMode`` and the dry run's counter count the kernels they
cannot see inside.  Under remat the recomputed forward saves its own
log-sum-exp for the backward.  Unlike the reference op, which falls back
to ``attention_ref`` for a ragged non-causal call, the kernel masks keys
past Skv itself.  ``flash_attention_bshd`` takes the model stack's
[B, S, H, D] layout, which the kernels read and write through strides
without a transpose copy.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

__all__ = ["attention_bwd_ref", "attention_lse_ref", "attention_ref",
           "flash_attention", "flash_attention_bshd", "kept_pairs"]


def _route(q: torch.Tensor, name: str) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); raises on any other device."""
    if q.device.type == "cuda":
        return True
    if q.device.type != "cpu":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return False


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if _route(q, "flash_attention"):
        return kernel.flash_attention_kernel(q, k, v, causal=causal)
    return (attention_ref(q, k, v, causal=causal),
            attention_lse_ref(q, k, v, causal=causal))


def _backward_op(q, k, v, out, lse, dout, causal):
    if _route(q, "flash_attention backward"):
        return kernel.flash_attention_bwd_kernel(q, k, v, out, lse, dout,
                                                 causal=causal)
    return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on K5 (CUDA tensors) or its plain version (CPU): the output
    and each row's log-sum-exp, float32 [B, H, Sq]."""
    return _forward(q, k, v, causal)


@flash_attention_fwd.register_fake
def _fake(q, k, v, causal):
    b, h, sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) on K5's backward kernel (CUDA tensors) or its plain
    version (CPU), from the forward's ``out`` and ``lse``."""
    return _backward_op(q, k, v, out, lse, dout, causal)


@flash_attention_bwd.register_fake
def _fake_bwd(q, k, v, out, lse, dout, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    out, lse = output
    ctx.causal = causal
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)


def _backward(ctx, grad, _grad_lse):
    q, k, v, out, lse = ctx.saved_tensors
    return (*flash_attention_bwd(q, k, v, out, lse, grad, ctx.causal), None)


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


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flops_bwd(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
               causal, *args, **kwargs) -> int:
    b, h, sq, d = q_shape
    return 10 * b * h * d * kept_pairs(sq, k_shape[2], causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention, [B, H, S, D] layout (see flash_attention_bshd for
    the model layout)."""
    return flash_attention_fwd(q, k, v, causal)[0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Model-stack layout: q [B, S, H, D]; k/v [B, S, KH, D]."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal)
    return out.transpose(1, 2)
