"""Shared building blocks: RMSNorm, RoPE, GQA attention, SwiGLU MLP (the
port of ``repro/models/layers.py``).

Plain functions on tensors: parameters are nested dicts of tensors with the
reference's keys and shapes.  A layer stack is a Python list of per-layer
dicts, and the reference's ``scan_layers`` (``lax.scan`` over a stacked
leading axis) becomes a loop over that list in the callers.  The
reference's ``ctx.constrain_*`` sharding hints are the identity on one
device and are left out; the port's ``parallel/`` brings them back.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama-style rotate-half)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, head_dim]; positions: broadcastable to [..., S]."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs      # [..,S,hd/2]
    cos = torch.cos(angles)[..., None, :]                        # [..,S,1,hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (train/prefill full-sequence path + one-token decode path)
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   d_model: Optional[int] = None, device=None) -> Params:
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    scale = 1.0 / math.sqrt(d)
    out_scale = 1.0 / math.sqrt(h * hd * 2 * cfg.n_layers)
    dt = cfg.pdtype()
    params = {
        "wq": normal(gen, (d, h, hd), scale, dt, device),
        "wk": normal(gen, (d, k, hd), scale, dt, device),
        "wv": normal(gen, (d, k, hd), scale, dt, device),
        "wo": normal(gen, (h, hd, d), out_scale, dt, device),
    }
    if cfg.qkv_bias:
        params["bq"] = torch.zeros((h, hd), dtype=dt, device=device)
        params["bk"] = torch.zeros((k, hd), dtype=dt, device=device)
        params["bv"] = torch.zeros((k, hd), dtype=dt, device=device)
    return params


def _qkv(params: Params, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor, rope: bool = True
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dtype = cfg.cdtype()
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    if "bq" in params:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0, unroll: bool = False
                      ) -> torch.Tensor:
    """Flash-style online-softmax attention in plain PyTorch (O(S·chunk)
    memory): the ``attn_impl="xla"`` path, which keeps the reference's
    name.

    q: [B, Sq, H, hd]; k/v: [B, Skv, K, hd] with H % K == 0.  ``unroll``
    widens the chunks as the reference's dry-run probes do (at most ~8x8
    chunk pairs); the loops are Python loops either way.
    """
    b, sq, h, hd = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    q = q.reshape(b, sq, kh, g, hd) * scale

    if unroll:
        q_chunk = max(q_chunk, sq // 8)
        kv_chunk = max(kv_chunk, skv // 8)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = sq // q_chunk if sq % q_chunk == 0 else -1
    nkv = skv // kv_chunk if skv % kv_chunk == 0 else -1
    if nq < 0 or nkv < 0:  # ragged fallback (tests with odd lengths)
        scores = torch.einsum("bikgh,bjkh->bkgij", q, k).to(torch.float32)
        if causal:
            qi = torch.arange(sq, device=q.device)[:, None] + q_offset
            kj = torch.arange(skv, device=q.device)[None, :]
            scores = torch.where(qi >= kj, scores, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgij,bjkh->bikgh", probs, v)
        return out.reshape(b, sq, h, hd)

    qc = q.reshape(b, nq, q_chunk, kh, g, hd)
    kc = k.reshape(b, nkv, kv_chunk, kh, hd)
    vc = v.reshape(b, nkv, kv_chunk, kh, hd)
    outs = []
    for qi in range(nq):
        q_blk = qc[:, qi]
        # online softmax over kv chunks
        acc = torch.zeros((b, q_chunk, kh, g, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, q_chunk, kh, g), float("-inf"),
                       dtype=torch.float32, device=q.device)
        l = torch.zeros((b, q_chunk, kh, g), dtype=torch.float32,
                        device=q.device)
        for kj in range(nkv):
            k_blk, v_blk = kc[:, kj], vc[:, kj]
            s = torch.einsum("bikgh,bjkh->bikgj", q_blk,
                             k_blk).to(torch.float32)
            if causal:
                qpos = (qi * q_chunk + q_offset +
                        torch.arange(q_chunk, device=q.device)[:, None])
                kpos = kj * kv_chunk + torch.arange(kv_chunk,
                                                    device=q.device)[None, :]
                mask = qpos >= kpos
                s = torch.where(mask[None, :, None, None, :], s,
                                float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bikgj,bjkh->bikgh", p.to(v_blk.dtype),
                v_blk).to(torch.float32)
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.stack(outs, dim=1)  # [B, nq, qc, kh, g, hd]
    return out.reshape(b, sq, h, hd).to(v.dtype)


def attention(params: Params, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              rope: bool = True) -> torch.Tensor:
    """Full-sequence attention. ``kv`` overrides keys/values (cross-attn)."""
    dtype = cfg.cdtype()
    q, k, v = _qkv(params, x, cfg, positions, rope=rope)
    if kv is not None:
        k, v = kv
        causal = False
    out = core_attention(q, k, v, cfg, causal)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))


def core_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ArchConfig, causal: bool) -> torch.Tensor:
    """softmax(q k^T) v in [B, S, H, hd] by ``cfg.attn_impl``: "flash" is
    kernel K5, "skip" the reference's ablation probe (q itself), anything
    else the plain chunked path."""
    if cfg.attn_impl == "flash":
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention_bshd
        return flash_attention_bshd(q, k, v, causal=causal)
    if cfg.attn_impl == "skip":
        return q
    return chunked_attention(q, k, v, causal=causal, unroll=cfg.scan_unroll)


def decode_attention(params: Params, x: torch.Tensor, cfg: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, cache_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: x [B, 1, D]; caches [B, S, K, hd]; pos [B].

    The new key and value are written into the caches in place (see
    :func:`_scatter_time`), which are returned."""
    dtype = cfg.cdtype()
    q, k, v = _qkv(params, x, cfg, pos[:, None])
    b = x.shape[0]
    k_cache = _scatter_time(k_cache, k, pos)
    v_cache = _scatter_time(v_cache, v, pos)
    h, kh = cfg.n_heads, cfg.n_kv_heads
    g = h // kh
    hd = cfg.resolved_head_dim
    qg = q.reshape(b, 1, kh, g, hd) / math.sqrt(hd)
    scores = torch.einsum("bikgh,bjkh->bkgij", qg,
                          k_cache.to(dtype)).to(torch.float32)
    t = torch.arange(cache_len, device=x.device)
    mask = t[None, :] <= pos[:, None]                     # [B, S]
    scores = torch.where(mask[:, None, None, None, :], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgij,bjkh->bikgh", probs, v_cache.to(dtype))
    out = out.reshape(b, 1, h, hd)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))
    return y, k_cache, v_cache


def _scatter_time(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
                  ) -> torch.Tensor:
    """cache [B,S,...] <- new [B,1,...] at per-batch position ``pos``.

    The reference blends a one-hot row into a new array; the port writes
    the row in place, which gives the same cache for finite values and
    saves a copy of it per layer and step.  ``pos`` must lie in [0, S)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long()] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, device=None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    scale = 1.0 / math.sqrt(d)
    out_scale = 1.0 / math.sqrt(f * 2 * cfg.n_layers)
    dt = cfg.pdtype()
    return {
        "w_gate": normal(gen, (d, f), scale, dt, device),
        "w_up": normal(gen, (d, f), scale, dt, device),
        "w_down": normal(gen, (f, d), out_scale, dt, device),
    }


def mlp(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dtype = cfg.cdtype()
    gate = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(dtype))
    up = torch.einsum("bsd,df->bsf", x, params["w_up"].to(dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(gate) * up,
                        params["w_down"].to(dtype))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg: ArchConfig, device=None
               ) -> Params:
    dt = cfg.pdtype()
    params = {"tok": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                            device)}
    if not cfg.tie_embeddings:
        params["head"] = normal(gen, (cfg.d_model, cfg.vocab_size),
                                1.0 / math.sqrt(cfg.d_model), dt, device)
    return params


def embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig
          ) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    return params["tok"][tokens.long()].to(cfg.cdtype())


def unembed(params: Params, x: torch.Tensor, cfg: ArchConfig
            ) -> torch.Tensor:
    dtype = cfg.cdtype()
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["tok"].to(dtype))
    return torch.einsum("bsd,dv->bsv", x, params["head"].to(dtype))
