"""Zamba2-style hybrid: a Mamba2 backbone plus one weight-shared attention
block (the port of ``repro/models/hybrid.py``).

The shared attention+MLP block (one parameter set) runs after every
``shared_attn_every``-th Mamba2 layer (``i % k == 0``); its attention is
``layers.attention``, so kernel K5 under ``attn_impl="flash"``.  The
Mamba2 layers are a list of per-layer dicts.  The decode cache keeps the
reference's stacked layout — Mamba states ``[L, ...]`` and one KV cache
per shared application ``[n_apps, B, S, KH, hd]`` — updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.parallel import ctx

Params = Dict[str, Any]


def n_shared_applications(cfg: ArchConfig) -> int:
    k = max(cfg.shared_attn_every, 1)
    return (cfg.n_layers + k - 1) // k


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (see ``transformer.init_params``)."""
    dev = runtime.device(device)
    gen = L.generator(seed, dev)
    layers = [{"ln": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
               "mamba": S.init_mamba2(gen, cfg, dev)}
              for _ in range(cfg.n_layers)]
    shared = {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
        "attn": L.init_attention(gen, cfg, device=dev),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
        "mlp": L.init_mlp(gen, cfg, device=dev),
    }
    return {
        "embed": L.init_embed(gen, cfg, dev),
        "layers": layers,
        "shared": shared,
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
    }


def _shared_block(shared: Params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(shared["attn"],
                        L.rmsnorm(shared["ln1"], x, cfg.norm_eps),
                        cfg, positions)
    return x + L.mlp(shared["mlp"],
                     L.rmsnorm(shared["ln2"], x, cfg.norm_eps), cfg)


def _layer(layer: Params, shared: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, with_shared: bool) -> torch.Tensor:
    """One Mamba2 layer, then the shared block where ``with_shared``."""
    x = x + S.mamba2_forward(layer["mamba"],
                             L.rmsnorm(layer["ln"], x, cfg.norm_eps), cfg)
    if with_shared:
        x = _shared_block(shared, x, cfg, positions)
    return ctx.constrain_residual(x)


def forward(params: Params, tokens: Optional[torch.Tensor], cfg: ArchConfig,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B,S,V] or, with ``hidden``, the
    post-final-norm hidden states; aux_loss 0)."""
    x = L.embed(params["embed"], tokens, cfg) if embeds is None else \
        embeds.to(cfg.cdtype())
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    k = max(cfg.shared_attn_every, 1)
    body = L.remat(_layer) if cfg.remat else _layer
    for i, layer in enumerate(params["layers"]):
        x = body(layer, params["shared"], x, cfg, positions, i % k == 0)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Decode: Mamba states are O(1) in context; only the shared-attention
# applications carry KV caches ([n_apps, B, S, K, hd]).
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Params:
    dev = runtime.device(device)
    hd = cfg.resolved_head_dim
    n_apps = n_shared_applications(cfg)
    state = S.mamba2_init_state(cfg, batch, device=dev)
    kv = (n_apps, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "mamba": {name: torch.zeros((cfg.n_layers,) + t.shape,
                                    dtype=t.dtype, device=dev)
                  for name, t in state.items()},
        "k": torch.zeros(kv, dtype=cfg.cdtype(), device=dev),
        "v": torch.zeros(kv, dtype=cfg.cdtype(), device=dev),
    }


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] at per-sequence position ``pos`` [B]; the cache is
    updated in place and returned."""
    x = L.embed(params["embed"], token[:, None], cfg)
    max_len = cache["k"].shape[2]
    k_mamba = max(cfg.shared_attn_every, 1)
    shared = params["shared"]
    mamba = cache["mamba"]
    app = 0
    for i, layer in enumerate(params["layers"]):
        state = {name: t[i] for name, t in mamba.items()}
        y, state = S.mamba2_step(layer["mamba"],
                                 L.rmsnorm(layer["ln"], x, cfg.norm_eps),
                                 state, cfg)
        x = x + y
        for name, t in state.items():
            ctx.set_layer(mamba[name], i, t)
        if i % k_mamba == 0:
            h = L.rmsnorm(shared["ln1"], x, cfg.norm_eps)
            y, _, _ = L.decode_attention(shared["attn"], h, cfg,
                                         cache["k"][app], cache["v"][app],
                                         pos, max_len)
            x = x + y
            x = x + L.mlp(shared["mlp"],
                          L.rmsnorm(shared["ln2"], x, cfg.norm_eps), cfg)
            app += 1
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], cache
