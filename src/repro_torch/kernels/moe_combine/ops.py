"""Public MoE combine op: each token's kept expert rows, gate-weighted and
summed in float32.

``repro_torch::moe_combine`` is an operator registered by device: CUDA
tensors launch the kernel (:mod:`.kernel`), CPU tensors take the plain
version (:mod:`.ref`), and any other device with storage has no
implementation and raises.  Its fake implementation (the output's shape
and dtype) lets a serving step run on fake or meta tensors, as the dry
run's do.  It has no autograd formula, so ``models.moe`` calls it only
where autograd does not record.  It is registered through
``torch.library.Library`` rather than ``torch.library.custom_op``, whose
Python wrapper costs the host ~20 µs more a call (24 calls a prefill).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_combine import kernel, ref

__all__ = ["moe_combine"]

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("moe_combine(Tensor out, Tensor combine_w, Tensor gate_idx, "
            "Tensor token_ids, Tensor gathered_mask) -> Tensor")
_LIB.impl("moe_combine", kernel.moe_combine_kernel, "CUDA")
_LIB.impl("moe_combine", ref.moe_combine_ref, "CPU")


@torch.library.register_fake("repro_torch::moe_combine")
def _fake(out, combine_w, gate_idx, token_ids, gathered_mask):
    return out.new_empty((gate_idx.shape[0], out.shape[2]))


def moe_combine(out: torch.Tensor, combine_w: torch.Tensor,
                gate_idx: torch.Tensor, token_ids: torch.Tensor,
                gathered_mask: torch.Tensor) -> torch.Tensor:
    """y [T, D] from the expert outputs ``out`` [E, C, D] and the
    router's ``combine_w`` [T, E], ``gate_idx`` [T, k], ``token_ids`` and
    ``gathered_mask`` [E, C] (:func:`repro_torch.models.moe.route`)."""
    return torch.ops.repro_torch.moe_combine(out, combine_w, gate_idx,
                                             token_ids, gathered_mask)
