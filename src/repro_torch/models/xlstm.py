"""xLSTM language model: alternating mLSTM / sLSTM blocks (the port of
``repro/models/xlstm.py``).

Every ``slstm_every``-th block is an sLSTM, the rest mLSTM, so the blocks
are a tuple of per-block dicts with no stacked axis, as in the reference.
The family has no attention and launches no kernel: its scans are plain
torch (``models/ssm.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.parallel import ctx

Params = Dict[str, Any]


def layer_kinds(cfg: ArchConfig) -> List[str]:
    k = cfg.slstm_every
    return ["slstm" if (k > 0 and (i + 1) % k == 0) else "mlstm"
            for i in range(cfg.n_layers)]


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (see ``transformer.init_params``)."""
    dev = runtime.device(device)
    gen = L.generator(seed, dev)
    blocks = []
    for kind in layer_kinds(cfg):
        init = S.init_slstm if kind == "slstm" else S.init_mlstm
        blocks.append({"ln": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
                       kind: init(gen, cfg, dev)})
    return {
        "embed": L.init_embed(gen, cfg, dev),
        "blocks": tuple(blocks),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype(), dev),
    }


def _block(block: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = L.rmsnorm(block["ln"], x, cfg.norm_eps)
    if "slstm" in block:
        return ctx.constrain_residual(
            x + S.slstm_forward(block["slstm"], h, cfg))
    return ctx.constrain_residual(
        x + S.mlstm_forward(block["mlstm"], h, cfg))


def forward(params: Params, tokens: Optional[torch.Tensor], cfg: ArchConfig,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B,S,V] or, with ``hidden``, the
    post-final-norm hidden states; aux_loss 0).  ``positions`` is unused
    (no attention), as in the reference."""
    x = L.embed(params["embed"], tokens, cfg) if embeds is None else \
        embeds.to(cfg.cdtype())
    body = L.remat(_block) if cfg.remat else _block
    for block in params["blocks"]:
        x = body(block, x, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Params:
    """One recurrent state per block (``max_len`` is unused: the states
    are constant in the context length)."""
    dev = runtime.device(device)
    return {"states": tuple(
        S.slstm_init_state(cfg, batch, dev) if kind == "slstm" else
        S.mlstm_init_state(cfg, batch, dev) for kind in layer_kinds(cfg))}


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Params]:
    x = L.embed(params["embed"], token[:, None], cfg)
    new_states = []
    for block, state in zip(params["blocks"], cache["states"]):
        h = L.rmsnorm(block["ln"], x, cfg.norm_eps)
        if "slstm" in block:
            y, state = S.slstm_step(block["slstm"], h, state, cfg)
        else:
            y, state = S.mlstm_step(block["mlstm"], h, state, cfg)
        x = x + y
        new_states.append(state)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], {"states": tuple(new_states)}
