"""Plain version of kernel K5 (the reference's ``flash_attention/ref.py``):
naive softmax attention in float32, causal mask top-left aligned
(row >= col), output in q's dtype."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k/v: [B, KH, Skv, D].  Naive softmax attention."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    g = h // kh
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    qg = q.reshape(b, kh, g, sq, d).to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bkgid,bkjd->bkgij", qg, kf)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None] >=
                torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgij,bkjd->bkgid", p, vf)
    return out.reshape(b, h, sq, d).to(q.dtype)
