"""Decoder-only transformer: the dense, MoE and VLM families (the port of
``repro/models/transformer.py``).

Parameters are the reference's tree with the stacked layer axis unrolled
into a list of per-layer dicts, and the layer scan is a loop over it.
A VLM (pixtral) is this model with patch embeddings (``embeds``) in front
of the tokens.  ``cfg.remat`` rematerializes each layer of the
full-sequence forward in the backward pass (``layers.remat``, the
reference's ``jax.checkpoint``), while autograd records; under ``remat``
kernel K5 runs twice a layer in a training step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.parallel import ctx

Params = Dict[str, Any]


def init_layer(gen: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    params = {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), device),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), device),
        "attn": L.init_attention(gen, cfg, device=device),
    }
    if cfg.moe:
        params["moe"] = M.init_moe(gen, cfg, device)
    else:
        params["mlp"] = L.init_mlp(gen, cfg, device=device)
    return params


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``.

    Drawn on the device itself; the reference's ``jax.random`` stream
    cannot be replayed, so weights that must equal the reference's come
    through :func:`repro_torch.models.convert.params_from_reference`."""
    dev = runtime.device(device)
    gen = L.generator(seed, dev)
    layers = [init_layer(gen, cfg, dev) for _ in range(cfg.n_layers)]
    return {
        "embed": L.init_embed(gen, cfg, dev),
        "layers": layers,
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
    }


def _ffn(layer: Params, h: torch.Tensor, cfg: ArchConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward half: the MoE layer (with its auxiliary
    loss) or the dense MLP (no loss)."""
    if cfg.moe:
        return M.moe_ffn(layer["moe"], h, cfg)
    return L.mlp(layer["mlp"], h, cfg), None


def layer_forward(layer: Params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x = ctx.constrain_residual(
        x + L.attention(layer["attn"], L.rmsnorm(layer["ln1"], x,
                                                 cfg.norm_eps),
                        cfg, positions))
    y, aux = _ffn(layer, L.rmsnorm(layer["ln2"], x, cfg.norm_eps), cfg)
    return ctx.constrain_residual(x + y), aux


def _inputs(params: Params, tokens: Optional[torch.Tensor],
            cfg: ArchConfig, embeds: Optional[torch.Tensor]) -> torch.Tensor:
    if embeds is None:
        return L.embed(params["embed"], tokens, cfg)
    x = embeds.to(cfg.cdtype())
    if tokens is not None:  # VLM: patch embeds ++ token embeds
        x = torch.cat([x, L.embed(params["embed"], tokens, cfg)], dim=1)
    return x


def forward(params: Params, tokens: Optional[torch.Tensor], cfg: ArchConfig,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: returns (logits [B,S,V], aux_loss).

    ``hidden=True`` returns the post-final-norm hidden states instead of
    logits.  ``aux_loss`` sums the MoE layers' load-balancing losses (0
    without MoE)."""
    x = _inputs(params, tokens, cfg, embeds)
    b, s, _ = x.shape
    x = ctx.constrain_residual(x)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = L.remat(layer_forward) if cfg.remat else layer_forward
    for layer in params["layers"]:
        x, layer_aux = body(layer, x, cfg, positions)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Decode (KV cache) path
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Params:
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    dev = runtime.device(device)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype(), device=dev),
            "v": torch.zeros(shape, dtype=cfg.cdtype(), device=dev)}


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] at per-sequence position ``pos`` [B] against the cache.

    The cache is updated in place and returned."""
    x = L.embed(params["embed"], token[:, None], cfg)
    max_len = cache["k"].shape[2]
    for i, layer in enumerate(params["layers"]):
        h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        y, _, _ = L.decode_attention(layer["attn"], h, cfg, cache["k"][i],
                                     cache["v"][i], pos, max_len)
        x = x + y
        x = x + _ffn(layer, L.rmsnorm(layer["ln2"], x, cfg.norm_eps), cfg)[0]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], cache


def prefill(params: Params, tokens: Optional[torch.Tensor], cfg: ArchConfig,
            max_len: int, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Run the full-sequence forward while materializing the KV cache
    ([L, B, max_len, KH, hd], zero past the prompt; on a mesh, DTensors
    placed by the cache rules, each rank writing its own shard).
    ``embeds`` are a VLM's patch embeddings, placed before ``tokens``."""
    x = _inputs(params, tokens, cfg, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, hd)
    cache = ctx.cache_zeros({"k": shape, "v": shape}, cfg.cdtype(), x, cfg,
                            b)
    for i, layer in enumerate(params["layers"]):
        h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(layer["attn"], h, cfg, positions)
        out = L.core_attention(q, k, v, cfg, causal=True)
        y = ctx.einsum("bshk,hkd->bsd", out,
                       layer["attn"]["wo"].to(cfg.cdtype()))
        x = ctx.constrain_residual(x + y)
        x = ctx.constrain_residual(
            x + _ffn(layer, L.rmsnorm(layer["ln2"], x, cfg.norm_eps), cfg)[0])
        ctx.write_prefix(cache["k"], i, k)
        ctx.write_prefix(cache["v"], i, v)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)
    return logits[:, 0], cache
