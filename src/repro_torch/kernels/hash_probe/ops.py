"""Public hash-probe op: point Gets against a bucketized table.

CUDA tensors launch kernel K3 (:mod:`.kernel`); CPU tensors take the
plain version (:mod:`.ref`); any other device raises.  ``build_table``
(numpy, on the host) makes the table both take.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.hash_probe import kernel, ref
from repro_torch.kernels.hash_probe.kernel import NOT_FOUND, multiply_shift
from repro_torch.kernels.hash_probe.ref import build_table

__all__ = ["DEFAULT_A", "NOT_FOUND", "build_table", "hash_probe",
           "hash_probe_pos", "multiply_shift"]

#: default multiply-shift coefficient (odd; fixed, like the reference's,
#: so runs are deterministic)
DEFAULT_A = 0x9E3779B1  # Knuth's 32-bit golden ratio, odd


def hash_probe_pos(table_keys: torch.Tensor, table_values: torch.Tensor,
                   queries: torch.Tensor, s: int, a: int = DEFAULT_A
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat slot pos | NOT_FOUND, value | 0) per query."""
    if queries.device.type == "cuda":
        return kernel.hash_probe_kernel(table_keys, table_values, queries,
                                        a, s)
    if queries.device.type != "cpu":
        raise ValueError(f"hash_probe runs on cpu or cuda, not "
                         f"{queries.device}")
    return ref.hash_probe_ref(table_keys, table_values, queries, a, s)


def hash_probe(table_keys: torch.Tensor, table_values: torch.Tensor,
               queries: torch.Tensor, s: int, a: int = DEFAULT_A
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found mask, values) for point probes against a bucketized table."""
    pos, val = hash_probe_pos(table_keys, table_values, queries, s, a)
    found = pos != NOT_FOUND
    return found, torch.where(found, val, torch.zeros_like(val))
