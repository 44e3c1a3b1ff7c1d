"""Plain version of kernel K5 (the reference's ``flash_attention/ref.py``):
naive softmax attention in float32, causal mask top-left aligned
(row >= col), output in q's dtype; and the plain versions of what the
port's kernel adds, the rows' log-sum-exp and the backward."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """q k^T scale in float32, [B, KH, G, Sq, Skv], masked to -inf."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    qg = q.reshape(b, kh, h // kh, sq, d).to(torch.float32) * scale
    s = torch.einsum("bkgid,bkjd->bkgij", qg, k.to(torch.float32))
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None] >=
                torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k/v: [B, KH, Skv, D].  Naive softmax attention."""
    b, h, sq, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    out = torch.einsum("bkgij,bkjd->bkgid", p, v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """ln sum_j exp(q_i k_j^T / sqrt(D)) over the keys the mask keeps, a
    row: float32 [B, H, Sq], -inf for a row that keeps no key (Skv = 0)."""
    b, h, sq, d = q.shape
    s = _scores(q, k, causal, 1.0 / math.sqrt(d))
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v from the saved ``out`` and
    ``lse`` (:func:`attention_lse_ref`), in float32, by the FlashAttention-2
    equations, no autograd: delta = rowsum(dO o O), P = exp(S scale - lse),
    dV = P^T dO, dP = dO V^T, dS = P o (dP - delta), dQ = scale dS K,
    dK = scale dS^T Q; dK and dV summed over each KV head's group.  A row
    with lse = -inf (no kept key) has P = 0.  Results in the inputs'
    dtypes."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    s = _scores(q, k, causal, scale)
    lse = lse.to(f32).reshape(b, kh, g, sq, 1)
    live = torch.isfinite(lse)
    p = torch.where(live, torch.exp(s - torch.where(live, lse, 0.0)), 0.0)
    dof = dout.to(f32).reshape(b, kh, g, sq, d)
    delta = (dof * out.to(f32).reshape(b, kh, g, sq, d)).sum(-1,
                                                             keepdim=True)
    dv = torch.einsum("bkgij,bkgid->bkjd", p, dof)
    dp = torch.einsum("bkgid,bkjd->bkgij", dof, v.to(f32))
    ds = p * (dp - delta)
    dq = torch.einsum("bkgij,bkjd->bkgid", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgij,bkgid->bkjd", ds,
                      q.to(f32).reshape(b, kh, g, sq, d)) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
