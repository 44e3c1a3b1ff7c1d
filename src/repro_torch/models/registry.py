"""Model registry: family dispatch for init / forward / decode (the port of
``repro/models/registry.py``).

    model = registry.build(cfg)
    params = model.init(seed)            # on runtime.device()
    logits, aux = model.forward(params, tokens)
    cache = model.init_cache(batch, max_len)
    logits, cache = model.decode_step(params, cache, token, pos)

Families: ``dense``/``moe``/``vlm`` (transformer, with a fused prefill),
``granite_hybrid`` (Granite 4.0-H, with a fused prefill), ``hybrid``
(zamba2), ``ssm`` (xLSTM), ``audio`` (encoder-decoder).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import (encdec, granite_hybrid, hybrid, transformer,
                                xlstm)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    _init: Callable
    _forward: Callable
    _init_cache: Callable
    _decode_step: Callable
    _prefill: Optional[Callable] = None

    def init(self, seed: int, device=None) -> Params:
        """Parameters drawn from a ``torch.Generator`` seeded with
        ``seed``, on ``device`` (default: :func:`repro_torch.runtime.device`)."""
        return self._init(seed, self.cfg, device=device)

    def forward(self, params, tokens, embeds=None, hidden=False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._forward(params, tokens, self.cfg, embeds=embeds,
                             hidden=hidden)

    def init_cache(self, batch: int, max_len: int, **kw) -> Params:
        return self._init_cache(self.cfg, batch, max_len, **kw)

    def decode_step(self, params, cache, token, pos):
        return self._decode_step(params, cache, token, pos, self.cfg)

    @property
    def has_prefill(self) -> bool:
        """Whether the family has a fused prefill (dense, moe, vlm,
        granite_hybrid)."""
        return self._prefill is not None

    def prefill(self, params, tokens, max_len, embeds=None):
        assert self._prefill is not None
        return self._prefill(params, tokens, self.cfg, max_len,
                             embeds=embeds)


def build(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return Model(cfg, transformer.init_params, transformer.forward,
                     transformer.init_cache, transformer.decode_step,
                     transformer.prefill)
    if cfg.family == "granite_hybrid":
        return Model(cfg, granite_hybrid.init_params, granite_hybrid.forward,
                     granite_hybrid.init_cache, granite_hybrid.decode_step,
                     granite_hybrid.prefill)
    if cfg.family == "hybrid":
        return Model(cfg, hybrid.init_params, hybrid.forward,
                     hybrid.init_cache, hybrid.decode_step)
    if cfg.family == "ssm":
        return Model(cfg, xlstm.init_params, xlstm.forward,
                     xlstm.init_cache, xlstm.decode_step)
    if cfg.family == "audio":
        return Model(cfg, encdec.init_params, encdec.forward,
                     encdec.init_cache, encdec.decode_step)
    raise ValueError(f"unknown family {cfg.family!r}")
