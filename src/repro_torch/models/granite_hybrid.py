"""Granite 4.0-H: Mamba2 and NoPE GQA token mixers, each layer's followed by
a capacity-routed MoE with a shared expert, under Granite's muP
multipliers.  A family of the port alone: the JAX package has no twin.

One layer, as HF ``GraniteMoeHybridDecoderLayer`` computes it::

    x = x + r * mixer(rmsnorm(x))          # Mamba2, or attention where
                                           # cfg.layer_types says so
    h = rmsnorm(x)
    x = x + r * (moe_ffn(h) + shared_mlp(h))

with ``r = cfg.residual_multiplier``.  The embeddings are scaled, the
attention's softmax scale set and the logits divided in ``layers.py``
(``embed``, ``_qkv``, ``unembed``) from the configuration.  The MoE layer
is ``moe.moe_ffn`` (capacity routing; the source's is dropless) and the
shared expert a SwiGLU MLP of width ``cfg.shared_expert_ff`` on the same
normed input, in a ``moe.shared`` span.

Serving has a fused prefill: each Mamba2 layer runs the prompt through
the chunked scan once and keeps the decode state it ends in (the scan's
final state and the conv's last inputs), each attention layer writes its
keys and values into the KV cache (kernel K5 under ``attn_impl="flash"``).
The decode cache keeps the hybrid family's layout: Mamba2 states stacked
``[n_mamba, ...]`` and KV caches ``[n_attention, B, S, KH, hd]``, written
in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import runtime, tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.parallel import ctx

Params = Dict[str, Any]

MAMBA, ATTENTION = "mamba", "attention"


def _kinds(cfg: ArchConfig) -> List[str]:
    kinds = list(cfg.layer_types)
    if len(kinds) != cfg.n_layers or set(kinds) - {MAMBA, ATTENTION}:
        raise ValueError(f"layer_types must give {cfg.n_layers} layers of "
                         f"{MAMBA!r} or {ATTENTION!r}, got {kinds}")
    return kinds


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (see ``transformer.init_params``)."""
    dev = runtime.device(device)
    gen = L.generator(seed, dev)
    layers = []
    for kind in _kinds(cfg):
        layer = {"ln1": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
                 "ln2": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev)}
        if kind == MAMBA:
            layer["mamba"] = S.init_mamba2(gen, cfg, dev)
        else:
            layer["attn"] = L.init_attention(gen, cfg, device=dev)
        layer["moe"] = M.init_moe(gen, cfg, dev)
        layer["shared"] = L.init_mlp(gen, cfg, d_ff=cfg.shared_expert_ff,
                                     device=dev)
        layers.append(layer)
    return {
        "embed": L.init_embed(gen, cfg, dev),
        "layers": layers,
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
    }


def _ffn(layer: Params, h: torch.Tensor, cfg: ArchConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts and the shared expert on the same normed input:
    (their sum, the MoE layer's auxiliary loss)."""
    y, aux = M.moe_ffn(layer["moe"], h, cfg)
    with tracing.span("moe.shared"):
        y = y + L.mlp(layer["shared"], h, cfg)
    return y, aux


def _residual(x: torch.Tensor, y: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return ctx.constrain_residual(x + y)


def layer_forward(layer: Params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
    if "mamba" in layer:
        y = S.mamba2_forward(layer["mamba"], h, cfg)
    else:
        y = L.attention(layer["attn"], h, cfg, positions)
    x = _residual(x, y, cfg)
    y, aux = _ffn(layer, L.rmsnorm(layer["ln2"], x, cfg.norm_eps), cfg)
    return _residual(x, y, cfg), aux


def forward(params: Params, tokens: Optional[torch.Tensor], cfg: ArchConfig,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B,S,V] or, with ``hidden``, the
    post-final-norm hidden states; the MoE layers' summed auxiliary
    loss)."""
    x = L.embed(params["embed"], tokens, cfg) if embeds is None else \
        embeds.to(cfg.cdtype())
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = L.remat(layer_forward) if cfg.remat else layer_forward
    for layer in params["layers"]:
        x, layer_aux = body(layer, x, cfg, positions)
        aux = aux + layer_aux
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Serving: the fused prefill and the decode step
# ---------------------------------------------------------------------------
def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int
                  ) -> Dict[str, Tuple[int, ...]]:
    kinds = _kinds(cfg)
    d_in, hd, h, n = S.mamba2_dims(cfg)
    n_mamba, n_attn = kinds.count(MAMBA), kinds.count(ATTENTION)
    kv = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"h": (n_mamba, batch, h, n, hd),
            "conv": (n_mamba, batch, S.CONV_WIDTH - 1, d_in + 2 * n),
            "k": kv, "v": kv}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Params:
    dev = runtime.device(device)
    shapes = _cache_shapes(cfg, batch, max_len)

    def zeros(name, dtype=cfg.cdtype()):
        return torch.zeros(shapes[name], dtype=dtype, device=dev)
    return {"mamba": {"h": zeros("h", torch.float32), "conv": zeros("conv")},
            "k": zeros("k"), "v": zeros("v")}


def prefill(params: Params, tokens: Optional[torch.Tensor], cfg: ArchConfig,
            max_len: int, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """The prompt through every layer once: (the last position's logits
    [B, V], the decode cache after the prompt).  A Mamba2 layer keeps the
    state its scan ends in and its conv's last inputs; an attention layer
    writes its keys and values into the KV cache (zero past the
    prompt)."""
    if embeds is not None:
        raise ValueError("granite_hybrid models take tokens, not embeds")
    x = L.embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cache = init_cache(cfg, b, max_len, device=x.device)
    mamba, j, a = cache["mamba"], 0, 0
    for layer in params["layers"]:
        h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        if "mamba" in layer:
            y, state = S.mamba2_prefill(layer["mamba"], h, cfg)
            for name, t in state.items():
                ctx.set_layer(mamba[name], j, t)
            j += 1
        else:
            q, k, v = L._qkv(layer["attn"], h, cfg, positions)
            out = L.core_attention(q, k, v, cfg, causal=True)
            y = ctx.einsum("bshk,hkd->bsd", out,
                           layer["attn"]["wo"].to(cfg.cdtype()))
            ctx.write_prefix(cache["k"], a, k)
            ctx.write_prefix(cache["v"], a, v)
            a += 1
        x = _residual(x, y, cfg)
        y, _ = _ffn(layer, L.rmsnorm(layer["ln2"], x, cfg.norm_eps), cfg)
        x = _residual(x, y, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] at per-sequence position ``pos`` [B]; the cache is
    updated in place and returned."""
    x = L.embed(params["embed"], token[:, None], cfg)
    max_len = cache["k"].shape[2]
    mamba, j, a = cache["mamba"], 0, 0
    for layer in params["layers"]:
        h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        if "mamba" in layer:
            state = {name: t[j] for name, t in mamba.items()}
            y, state = S.mamba2_step(layer["mamba"], h, state, cfg)
            for name, t in state.items():
                ctx.set_layer(mamba[name], j, t)
            j += 1
        else:
            y, _, _ = L.decode_attention(layer["attn"], h, cfg,
                                         cache["k"][a], cache["v"][a], pos,
                                         max_len)
            a += 1
        x = _residual(x, y, cfg)
        y, _ = _ffn(layer, L.rmsnorm(layer["ln2"], x, cfg.norm_eps), cfg)
        x = _residual(x, y, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], cache
