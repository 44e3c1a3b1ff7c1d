"""Decoder-only transformer, dense family (the port of
``repro/models/transformer.py``).

Parameters are the reference's tree with the stacked layer axis unrolled
into a list of per-layer dicts, and the layer scan is a loop over it.
``cfg.moe`` raises until ``models/moe.py`` is ported (ROADMAP Queue 1);
``cfg.remat`` only matters to training and is ignored here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE layers need models/moe.py, which the port "
            f"does not have yet (ROADMAP Queue 1)")


def init_layer(gen: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    _dense_only(cfg)
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), device),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), device),
        "attn": L.init_attention(gen, cfg, device=device),
        "mlp": L.init_mlp(gen, cfg, device=device),
    }


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``.

    Drawn on the device itself; the reference's ``jax.random`` stream
    cannot be replayed, so weights that must equal the reference's come
    through :func:`repro_torch.models.convert.params_from_reference`."""
    dev = runtime.device(device)
    _dense_only(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    layers = [init_layer(gen, cfg, dev) for _ in range(cfg.n_layers)]
    return {
        "embed": L.init_embed(gen, cfg, dev),
        "layers": layers,
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
    }


def layer_forward(layer: Params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(layer["attn"], L.rmsnorm(layer["ln1"], x,
                                                 cfg.norm_eps),
                        cfg, positions)
    h = L.rmsnorm(layer["ln2"], x, cfg.norm_eps)
    return x + L.mlp(layer["mlp"], h, cfg)


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
    logits.  The dense family has no auxiliary loss: it is 0."""
    _dense_only(cfg)
    x = _inputs(params, tokens, cfg, embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for layer in params["layers"]:
        x = layer_forward(layer, x, cfg, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
    _dense_only(cfg)
    x = L.embed(params["embed"], token[:, None], cfg)
    max_len = cache["k"].shape[2]
    for i, layer in enumerate(params["layers"]):
        h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        y, _, _ = L.decode_attention(layer["attn"], h, cfg, cache["k"][i],
                                     cache["v"][i], pos, max_len)
        x = x + y
        h = L.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(layer["mlp"], h, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], cache


def prefill(params: Params, tokens: Optional[torch.Tensor], cfg: ArchConfig,
            max_len: int, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Run the full-sequence forward while materializing the KV cache
    ([L, B, max_len, KH, hd], zero past the prompt)."""
    _dense_only(cfg)
    x = _inputs(params, tokens, cfg, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, hd)
    ks = torch.zeros(shape, dtype=cfg.cdtype(), device=x.device)
    vs = torch.zeros(shape, dtype=cfg.cdtype(), device=x.device)
    for i, layer in enumerate(params["layers"]):
        h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(layer["attn"], h, cfg, positions)
        out = L.core_attention(q, k, v, cfg, causal=True)
        y = torch.einsum("bshk,hkd->bsd", out,
                         layer["attn"]["wo"].to(cfg.cdtype()))
        x = x + y
        h = L.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(layer["mlp"], h, cfg)
        ks[i, :, :s] = k
        vs[i, :, :s] = v
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)
    return logits[:, 0], {"k": ks, "v": vs}
