"""Public scan ops over an unsorted node: ``scan_filter`` (first match
and range count) and ``scan_get`` (the paper's Get over a UDP terminal).

CUDA tensors launch kernel K2 (:mod:`.kernel`); CPU tensors take the
plain version (:mod:`.ref`); any other device raises.  Both outputs are
computed on every call, as the reference computes them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.scan_filter import kernel, ref
from repro_torch.kernels.scan_filter.kernel import NOT_FOUND

__all__ = ["NOT_FOUND", "scan_filter", "scan_get"]


def scan_filter(keys: torch.Tensor, queries: torch.Tensor,
                lo: torch.Tensor, hi: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first-match pos | NOT_FOUND, range count) over an unsorted node."""
    if queries.device.type == "cuda":
        return kernel.scan_filter_kernel(keys, queries, lo, hi)
    if queries.device.type != "cpu":
        raise ValueError(f"scan_filter runs on cpu or cuda, not "
                         f"{queries.device}")
    return ref.scan_filter_ref(keys, queries, lo, hi)


def scan_get(keys: torch.Tensor, values: torch.Tensor,
             queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point Get over an unsorted node: (found mask, values | 0)."""
    pos, _ = scan_filter(keys, queries, queries, queries)
    found = pos != NOT_FOUND
    if values.shape[0] == 0:
        return found, torch.zeros(queries.shape, dtype=values.dtype,
                                  device=values.device)
    idx = torch.where(found, pos, 0).long()
    return found, torch.where(found, values[idx],
                              torch.zeros((), dtype=values.dtype,
                                          device=values.device))
