"""Public SSD scan op: Mamba2's chunked scan with one group of B and C.

``repro_torch::ssd_scan`` is an operator registered by device: CUDA
tensors launch the kernel (:mod:`.kernel`), CPU tensors take the plain
version (:func:`repro_torch.models.ssm.chunked_linear_scan`), and any
other device with storage has no implementation and raises.  Each route
opens one ``chunked_linear_scan`` span around all its work.  Its fake
implementation (the outputs' shapes and dtypes) lets a serving step run on
fake or meta tensors, as the dry run's do.  It has no autograd formula, so
``models.ssm`` calls it only where autograd does not record.  It is
registered through ``torch.library.Library`` rather than
``torch.library.custom_op``, whose Python wrapper costs the host more a
call (see :mod:`repro_torch.kernels.moe_combine.ops`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel

__all__ = ["ssd_scan"]


def _plain(x, B, C, loga, chunk, h0=None):
    # imported here: models.ssm imports this module
    from repro_torch.models.ssm import chunked_linear_scan
    return chunked_linear_scan(x, B, C, loga, chunk, h0)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor B, Tensor C, Tensor loga, int chunk, "
            "Tensor? h0=None) -> (Tensor, Tensor)")
_LIB.impl("ssd_scan", kernel.ssd_scan_kernel, "CUDA")
_LIB.impl("ssd_scan", _plain, "CPU")


@torch.library.register_fake("repro_torch::ssd_scan")
def _fake(x, B, C, loga, chunk, h0=None):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)),
            x.new_empty((b, h, B.shape[-1], p), dtype=torch.float32))


def ssd_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             loga: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [b, s, h, p] in x's dtype, the final state [b, h, n, p] in
    float32) for x [b, s, h, p] (dt-scaled), B and C [b, s, g, n], the
    log decays ``loga`` [b, s, h] in float32, chunks of ``chunk`` and the
    starting state ``h0`` (zeros when None).  The kernel takes one group
    only; the CPU takes any."""
    return torch.ops.repro_torch.ssd_scan(x, B, C, loga, chunk, h0)
