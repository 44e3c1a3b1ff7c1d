"""Training step: loss, grads, clipping, AdamW, with microbatch gradient
accumulation (the port of ``repro/train/loop.py``).

Functional, as the reference: a step takes a :class:`TrainState` and
returns a new one, leaving its input as it was (so one state can be
stepped twice, as the checks on the card do).  PyTorch runs eagerly, so
the reference's ``jax.jit`` and its donation have no counterpart; the
caller drops the old state when a step returns.  On a mesh of several
devices the state and batch are DTensors (``launch.train`` places them):
each gradient is redistributed to its parameter's placements, so the
state keeps its layout step after step.

Under a profiler a step is five sibling spans (``repro_torch/tracing.py``):
``train.forward`` (the model), ``train.loss`` (the chunked CE),
``train.backward`` (the gradient, with the remat'd blocks' and CE slices'
recompute, and its accumulation over microbatches), ``train.clip``
(the clip) and ``train.adamw`` (AdamW and the update's application).
Without microbatches, ``run.grad_compression``'s cast lies between
``train.backward`` and ``train.clip``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import runtime, tracing
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     apply_updates, clip_by_global_norm,
                                     tree_leaves, tree_map)
from repro_torch.parallel import ctx

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: AdamWState


def init_state(model: Model, seed: int, device=None,
               moment_dtype=torch.float32) -> TrainState:
    """Parameters from ``model.init(seed)`` on ``device`` (default:
    :func:`repro_torch.runtime.device`; the meta device gives shapes
    alone) and zero AdamW moments of ``moment_dtype``."""
    params = model.init(seed, device=runtime.device(device))
    return TrainState(params, adamw_init(params, moment_dtype))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """logits [B,S,V] (any float dtype), labels [B,S] int."""
    logits = ctx.constrain_bsd(logits).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


#: sequence positions per chunked-CE slice: at qwen2-1.5b's vocab of
#: 151,936 one slice of 4 sequences holds 1.24 GB of float32 logits
CE_CHUNK = 512


def _ce_slice(x_blk: torch.Tensor, l_blk: torch.Tensor, embed: Params,
              cfg: ArchConfig) -> torch.Tensor:
    # the vocabulary whole on each rank: the gold logit's gather
    logits = ctx.constrain_bsd(L.unembed(embed, x_blk, cfg)).to(
        torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_blk[..., None].long())[..., 0]
    return (logz - gold).sum()


def chunked_cross_entropy(x: torch.Tensor, embed: Params,
                          labels: torch.Tensor, cfg: ArchConfig
                          ) -> torch.Tensor:
    """CE over hidden states without materializing [B,S,V] logits.

    Loops over the sequence in CE_CHUNK slices; each slice computes its
    logits, reduces them to (logsumexp - gold), and frees them.  Each
    slice is rematerialized (``torch.utils.checkpoint``), so the backward
    pass also recomputes its logits instead of keeping them.  A sequence
    that is not a whole number of slices takes the naive loss."""
    x = ctx.enter_block(x)            # slices of the whole sequence
    b, s, d = x.shape
    chunk = min(CE_CHUNK, s)
    if s % chunk != 0:
        return cross_entropy_loss(L.unembed(embed, x, cfg), labels)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        if torch.is_grad_enabled():
            part = checkpoint(_ce_slice, x[:, sl], labels[:, sl], embed, cfg,
                              use_reentrant=False)
        else:
            part = _ce_slice(x[:, sl], labels[:, sl], embed, cfg)
        total = total + part
    return total / (b * s)


def _loss_fn(params: Params, batch: Dict[str, torch.Tensor], model: Model
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    embeds = batch.get("embeds")
    labels = batch["labels"]
    with tracing.span("train.forward"):
        x, aux = model.forward(params, batch["tokens"], embeds=embeds,
                               hidden=True)
    # VLM: hidden states cover [patches ++ text]; loss on text positions
    if x.shape[1] != labels.shape[1]:
        x = x[:, -labels.shape[1]:]
    with tracing.span("train.loss"):
        loss = chunked_cross_entropy(x, params["embed"], labels, model.cfg)
        total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux}


def loss_and_grads(params: Params, batch: Dict[str, torch.Tensor],
                   model: Model) -> Tuple[Dict[str, torch.Tensor], Params]:
    """The metrics (``loss``, ``aux_loss``, detached) and the gradient of
    ``loss + 0.01 aux`` for every parameter (zeros where a parameter does
    not reach the loss, as ``jax.grad`` gives), in the parameters' tree
    and dtypes.  ``params`` are not modified."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, metrics = _loss_fn(live, batch, model)
        leaves = tree_leaves(live)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            grads = iter([torch.zeros_like(p) if g is None
                          else _placed_as(g, p)
                          for p, g in zip(leaves, grads)])
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (a partial sum
    reduced, scattered where the parameter is split)."""
    if isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               model: Model, run: RunConfig
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step: the gradient (accumulated over microbatches of
    ``run.microbatch`` rows when that is set and smaller than the batch),
    clipped to ``run.grad_clip``, then AdamW, as the reference orders it.
    ``run.grad_compression`` rounds each gradient to bf16 (and
    accumulates in bf16), as the reference does before its cross-replica
    reduction; the clip and Adam's math stay float32."""
    micro = run.microbatch
    compress = (lambda g: g.to(torch.bfloat16)) if run.grad_compression \
        else (lambda g: g)
    b = batch["tokens"].shape[0]
    if micro and micro < b:
        n_micro = b // micro
        acc_dtype = torch.bfloat16 if run.grad_compression else torch.float32
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype),
                         state.params)
        parts = []
        for i in range(n_micro):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            metrics, g = loss_and_grads(state.params, mb, model)
            with tracing.span("train.backward"):
                tree_map(lambda a, gi: a.add_((compress(gi) / n_micro
                                               ).to(a.dtype)), grads, g)
            parts.append(metrics)
            del g
        metrics = {k: torch.stack([m[k] for m in parts]).mean()
                   for k in parts[0]}
    else:
        metrics, grads = loss_and_grads(state.params, batch, model)
        grads = tree_map(compress, grads)
    with tracing.span("train.clip"):
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    with tracing.span("train.adamw"):
        updates, opt = adamw_update(grads, state.opt, state.params, run)
        del grads
        params = apply_updates(state.params, updates)
    metrics = dict(metrics, grad_norm=gnorm)
    return TrainState(params, opt), metrics


def make_train_step(model: Model, run: RunConfig):
    """``step(state, batch) -> (state, metrics)``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return train_step(state, batch, model, run)

    return step
