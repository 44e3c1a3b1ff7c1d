"""Serving: batched prefill + decode steps with KV caches (the port of
``repro/train/serve.py``).

``make_serve_step`` returns the one-token decode closure;
``make_prefill_step`` the fused prefill (kernel K5 when
``cfg.attn_impl == "flash"``); ``generate`` is the batched greedy loop.
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
        if model._prefill is not None:
            return model.prefill(params, tokens, max_len, embeds=embeds)
        # families without a fused prefill: full forward, last-token logits
        logits, _ = model.forward(params, tokens, embeds=embeds)
        return logits[:, -1], None

    return step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(model: Model, params: Params, prompt: torch.Tensor,
             max_new_tokens: int, max_len: Optional[int] = None,
             embeds=None) -> torch.Tensor:
    """Batched greedy generation: prompt [B, S] -> [B, S + new] (on the
    prompt's device)."""
    b, s = prompt.shape
    max_len = max_len or (s + max_new_tokens)
    cache = model.init_cache(b, max_len, device=prompt.device)
    decode = make_serve_step(model)

    # prefill by stepping the prompt (works for every family; transformer
    # families could use the fused prefill instead)
    pos = torch.zeros((b,), dtype=torch.int32, device=prompt.device)
    logits = None
    for t in range(s):
        logits, cache = decode(params, cache, prompt[:, t], pos)
        pos = pos + 1
    tokens = [prompt.to(torch.int32)]
    token = greedy_sample(logits)
    for _ in range(max_new_tokens - 1):
        tokens.append(token[:, None])
        logits, cache = decode(params, cache, token, pos)
        pos = pos + 1
        token = greedy_sample(logits)
    tokens.append(token[:, None])
    return torch.cat(tokens, dim=1)
