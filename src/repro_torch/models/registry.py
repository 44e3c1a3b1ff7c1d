"""Model registry: family dispatch for init / forward / decode (the port of
``repro/models/registry.py``).

    model = registry.build(cfg)
    params = model.init(seed)            # on runtime.device()
    logits, aux = model.forward(params, tokens)
    cache = model.init_cache(batch, max_len)
    logits, cache = model.decode_step(params, cache, token, pos)

Only the ``dense`` family is ported; the others raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

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

    def prefill(self, params, tokens, max_len, embeds=None):
        assert self._prefill is not None
        return self._prefill(params, tokens, self.cfg, max_len,
                             embeds=embeds)


def build(cfg: ArchConfig) -> Model:
    if cfg.family == "dense":
        return Model(cfg, transformer.init_params, transformer.forward,
                     transformer.init_cache, transformer.decode_step,
                     transformer.prefill)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (the port has 'dense'; "
        f"see ROADMAP Queue 1)")
