"""Plain version of the MoE combine as a gather, and its slot map.

:func:`slot_map` names, for each token and each of its k experts, the
capacity slot that took the pair (-1 where none did); :func:`moe_combine_ref`
sums each token's kept rows, weighted by their float32 gates, in float32
in the order of the token's top-k list, and reads no other row.  It is the
kernel's arithmetic in plain PyTorch (products and sums rounded apart,
where the kernel fuses them).
"""
from __future__ import annotations

import torch


def slot_map(gate_idx: torch.Tensor, token_ids: torch.Tensor,
             gathered_mask: torch.Tensor) -> torch.Tensor:
    """[T, k] int64: ``e C + s`` where slot s of expert e = gate_idx[t, j]
    holds token t (gathered_mask 1), else -1."""
    e, c = token_ids.shape
    t, k = gate_idx.shape
    kept = torch.nonzero(gathered_mask.reshape(-1) != 0).reshape(-1)
    tok = token_ids.reshape(-1)[kept]
    expert = torch.div(kept, c, rounding_mode="floor")
    j = torch.argmax((gate_idx[tok] == expert[:, None]).to(torch.int8),
                     dim=1)
    out = torch.full((t, k), -1, dtype=torch.int64, device=gate_idx.device)
    out[tok, j] = kept
    return out


def moe_combine_ref(out: torch.Tensor, combine_w: torch.Tensor,
                    gate_idx: torch.Tensor, token_ids: torch.Tensor,
                    gathered_mask: torch.Tensor) -> torch.Tensor:
    """y [T, D] in ``out``'s dtype (see :mod:`.kernel`)."""
    e, c, d = out.shape
    t, k = gate_idx.shape
    slots = slot_map(gate_idx, token_ids, gathered_mask)
    rows = out.reshape(e * c, d)
    acc = torch.zeros((t, d), dtype=torch.float32, device=out.device)
    for j in range(k):
        took = torch.nonzero(slots[:, j] >= 0).reshape(-1)
        s = slots[took, j]
        w = combine_w[took, torch.div(s, c, rounding_mode="floor")]
        acc[took] += w[:, None] * rows[s].to(torch.float32)
    return acc.to(out.dtype)
