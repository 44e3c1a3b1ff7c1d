"""Encoder-decoder backbone (seamless-m4t): encoder and decoder stacks
(the port of ``repro/models/encdec.py``).

The encoder takes precomputed frame embeddings (the modality frontend is a
stub, as in the reference) through non-causal self-attention; decoder
layers add cross-attention over the encoder output.  Both run on kernel
K5 under ``attn_impl="flash"``: the encoder non-causal, cross-attention
non-causal with Sq != Skv.  In the decode step, cross-attention over the
cached encoder KV is the plain chunked path, as in the reference.

As in the reference, ``forward`` ropes the cross-attention queries (it
goes through ``layers.attention``) and ``decode_step`` does not.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.parallel import ctx

Params = Dict[str, Any]


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (see ``transformer.init_params``)."""
    dev = runtime.device(device)
    gen = L.generator(seed, dev)
    pd = cfg.pdtype()

    def enc_layer():
        return {"ln1": L.init_rmsnorm(cfg.d_model, pd, dev),
                "attn": L.init_attention(gen, cfg, device=dev),
                "ln2": L.init_rmsnorm(cfg.d_model, pd, dev),
                "mlp": L.init_mlp(gen, cfg, device=dev)}

    def dec_layer():
        return {"ln1": L.init_rmsnorm(cfg.d_model, pd, dev),
                "attn": L.init_attention(gen, cfg, device=dev),
                "ln_x": L.init_rmsnorm(cfg.d_model, pd, dev),
                "xattn": L.init_attention(gen, cfg, device=dev),
                "ln2": L.init_rmsnorm(cfg.d_model, pd, dev),
                "mlp": L.init_mlp(gen, cfg, device=dev)}

    return {
        "embed": L.init_embed(gen, cfg, dev),
        "encoder": [enc_layer() for _ in range(cfg.n_encoder_layers)],
        "decoder": [dec_layer() for _ in range(cfg.n_layers)],
        "enc_norm": L.init_rmsnorm(cfg.d_model, pd, dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, pd, dev),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, device=x.device)[None].expand(b, s)


def _enc_layer(layer: Params, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(layer["attn"],
                        L.rmsnorm(layer["ln1"], x, cfg.norm_eps),
                        cfg, positions, causal=False)
    return ctx.constrain_residual(
        x + L.mlp(layer["mlp"], L.rmsnorm(layer["ln2"], x, cfg.norm_eps),
                  cfg))


def encode(params: Params, src_embeds: torch.Tensor, cfg: ArchConfig
           ) -> torch.Tensor:
    """Source frames [B, S_src, D] -> the normed encoder output.  Each
    layer is rematerialized in training under ``cfg.remat``."""
    x = src_embeds.to(cfg.cdtype())
    positions = _positions(x)
    body = L.remat(_enc_layer) if cfg.remat else _enc_layer
    for layer in params["encoder"]:
        x = body(layer, x, cfg, positions)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(layer: Params, x: torch.Tensor, enc_kv, cfg: ArchConfig,
               positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(layer["attn"],
                        L.rmsnorm(layer["ln1"], x, cfg.norm_eps),
                        cfg, positions)
    x = x + L.attention(layer["xattn"],
                        L.rmsnorm(layer["ln_x"], x, cfg.norm_eps),
                        cfg, positions, kv=enc_kv)
    return ctx.constrain_residual(
        x + L.mlp(layer["mlp"], L.rmsnorm(layer["ln2"], x, cfg.norm_eps),
                  cfg))


def _dec_body(layer: Params, x: torch.Tensor, enc_out: torch.Tensor,
              cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    """A decoder layer with its cross-attention K/V from ``enc_out`` (the
    reference's rematerialized scan body)."""
    return _dec_layer(layer, x, _cross_kv(layer, enc_out, cfg), cfg,
                      positions)


def _cross_kv(layer: Params, enc_out: torch.Tensor, cfg: ArchConfig):
    dtype = cfg.cdtype()
    xattn = layer["xattn"]
    k = ctx.einsum("bsd,dhk->bshk", enc_out, xattn["wk"].to(dtype))
    v = ctx.einsum("bsd,dhk->bshk", enc_out, xattn["wv"].to(dtype))
    if "bk" in xattn:
        k = k + xattn["bk"].to(dtype)
        v = v + xattn["bv"].to(dtype)
    return k, v


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward.  ``embeds`` = source frame embeddings,
    ``tokens`` = target tokens; (logits or, with ``hidden``, the
    post-final-norm hidden states; aux_loss 0)."""
    if embeds is None:
        raise ValueError("the encoder-decoder needs source embeddings "
                         "(embeds=)")
    enc_out = encode(params, embeds, cfg)
    x = L.embed(params["embed"], tokens, cfg)
    if positions is None:
        positions = _positions(x)
    body = L.remat(_dec_body) if cfg.remat else _dec_body
    for layer in params["decoder"]:
        x = body(layer, x, enc_out, cfg, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Decode: self-attention KV cache + precomputed cross-attention KV per layer
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               src_len: int = 4096, device=None) -> Params:
    dev = runtime.device(device)
    hd = cfg.resolved_head_dim
    self_kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    cross_kv = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, hd)
    return {name: torch.zeros(shape, dtype=cfg.cdtype(), device=dev)
            for name, shape in (("k", self_kv), ("v", self_kv),
                                ("xk", cross_kv), ("xv", cross_kv))}


def prefill_cross(params: Params, src_embeds: torch.Tensor, cfg: ArchConfig,
                  cache: Params) -> Params:
    """Encode the source and store every decoder layer's cross-attention
    K/V ([L, B, S_src, KH, hd]) in a new cache dict."""
    enc_out = encode(params, src_embeds, cfg)
    kvs = [_cross_kv(layer, enc_out, cfg) for layer in params["decoder"]]
    return dict(cache, xk=torch.stack([k for k, _ in kvs]),
                xv=torch.stack([v for _, v in kvs]))


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] at ``pos`` [B]; the self-attention cache is updated in
    place and the cache returned."""
    x = L.embed(params["embed"], token[:, None], cfg)
    max_len = cache["k"].shape[2]
    dtype = cfg.cdtype()
    for i, layer in enumerate(params["decoder"]):
        h = L.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        y, _, _ = L.decode_attention(layer["attn"], h, cfg, cache["k"][i],
                                     cache["v"][i], pos, max_len)
        x = x + y
        # cross attention against the precomputed encoder KV
        h = L.rmsnorm(layer["ln_x"], x, cfg.norm_eps)
        q, _, _ = L._qkv(layer["xattn"], h, cfg, pos[:, None], rope=False)
        out = ctx.heads_local(
            lambda q, k, v: L.chunked_attention(q, k, v, causal=False,
                                                unroll=cfg.scan_unroll),
            q, cache["xk"][i], cache["xv"][i])
        x = x + ctx.einsum("bshk,hkd->bsd", out,
                           layer["xattn"]["wo"].to(dtype))
        x = x + L.mlp(layer["mlp"],
                      L.rmsnorm(layer["ln2"], x, cfg.norm_eps), cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], cache
