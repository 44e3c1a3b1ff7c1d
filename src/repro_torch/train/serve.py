"""Serving: batched prefill + decode steps with KV caches (the port of
``repro/train/serve.py``).

``make_serve_step`` returns the one-token decode closure;
``make_prefill_step`` the fused prefill (kernel K5 when
``cfg.attn_impl == "flash"``); ``prefill`` is what a server runs before
decoding: the fused prefill where the family has one (dense, moe, vlm,
granite_hybrid), else the prompt stepped through the decode closure
(``step_prompt``; hybrid, ssm, audio); ``generate`` is the batched greedy
loop.
PyTorch runs eagerly, so the reference's ``jax.jit`` has no counterpart.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.registry import Model

Params = Any


def make_serve_step(model: Model):
    def step(params: Params, cache: Params, token: torch.Tensor,
             pos: torch.Tensor):
        logits, cache = model.decode_step(params, cache, token, pos)
        return logits, cache

    return step


def make_prefill_step(model: Model, max_len: int):
    def step(params: Params, tokens: Optional[torch.Tensor],
             embeds: Optional[torch.Tensor] = None):
        if model.has_prefill:
            return model.prefill(params, tokens, max_len, embeds=embeds)
        # families without a fused prefill: full forward, last-token logits
        logits, _ = model.forward(params, tokens, embeds=embeds)
        return logits[:, -1], None

    return step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def step_prompt(model: Model, params: Params, prompt: torch.Tensor,
                cache: Params):
    """Step ``prompt`` [B, S] through the decode closure from position 0
    (works for every family): the last position's logits and the
    cache."""
    decode = make_serve_step(model)
    pos = torch.zeros((prompt.shape[0],), dtype=torch.int32,
                      device=prompt.device)
    logits = None
    for t in range(prompt.shape[1]):
        logits, cache = decode(params, cache, prompt[:, t], pos)
        pos = pos + 1
    return logits, cache


def prefill(model: Model, params: Params, prompt: torch.Tensor,
            max_len: int, embeds: Optional[torch.Tensor] = None,
            **cache_kw):
    """The prompt's last-token logits and the cache to decode from: the
    fused prefill where the family has one (dense, moe, vlm,
    granite_hybrid; a VLM's patch ``embeds`` go before the tokens), else
    the prompt stepped into ``model.init_cache(B, max_len, **cache_kw)`` (``src_len`` for
    the encoder-decoder)."""
    if model.has_prefill:
        return model.prefill(params, prompt, max_len, embeds=embeds)
    if embeds is not None:
        raise ValueError(f"{model.cfg.family!r} models are served by "
                         f"stepping tokens and take no embeds")
    cache = model.init_cache(prompt.shape[0], max_len, device=prompt.device,
                             **cache_kw)
    return step_prompt(model, params, prompt, cache)


@torch.no_grad()
def generate(model: Model, params: Params, prompt: torch.Tensor,
             max_new_tokens: int, max_len: Optional[int] = None,
             embeds=None) -> torch.Tensor:
    """Batched greedy generation: prompt [B, S] -> [B, S + new] (on the
    prompt's device)."""
    b, s = prompt.shape
    max_len = max_len or (s + max_new_tokens)
    decode = make_serve_step(model)

    # prefill by stepping the prompt (works for every family; transformer
    # families could use the fused prefill instead)
    logits, cache = step_prompt(
        model, params, prompt,
        model.init_cache(b, max_len, device=prompt.device))
    pos = torch.full((b,), s, dtype=torch.int32, device=prompt.device)
    tokens = [prompt.to(torch.int32)]
    token = greedy_sample(logits)
    for _ in range(max_new_tokens - 1):
        tokens.append(token[:, None])
        logits, cache = decode(params, cache, token, pos)
        pos = pos + 1
        token = greedy_sample(logits)
    tokens.append(token[:, None])
    return torch.cat(tokens, dim=1)
