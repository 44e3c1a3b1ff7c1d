"""AdamW + global-norm clipping + warmup-cosine schedule, in torch.

The port's twin of the reference's ``optim/adamw.py``, as plain functions
on parameter trees: dicts (nested dicts, lists and tuples too) whose
leaves are tensors.  Moments are kept in float32 regardless of param dtype
(bf16 params at scale); the schedule and the update are computed in
float32 on the parameters' device and cast back — the standard
mixed-precision recipe.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import RunConfig

Params = Any


def tree_map(fn: Callable[..., torch.Tensor], tree: Params,
             *rest: Params) -> Params:
    """``fn`` over the tensor leaves of ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Params
    nu: Params


def adamw_init(params: Params, moment_dtype=torch.float32) -> AdamWState:
    """``moment_dtype=torch.bfloat16`` halves optimizer-state memory
    (low-precision moments; the update math itself stays float32)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def cosine_schedule(step: torch.Tensor, run: RunConfig) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(run.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - run.warmup_steps) /
                           max(run.total_steps - run.warmup_steps, 1),
                           0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return run.learning_rate * warm * (0.1 + 0.9 * cos)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gnorm


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 run: RunConfig) -> Tuple[Params, AdamWState]:
    step = state.step + 1
    lr = cosine_schedule(step, run)
    b1, b2 = run.b1, run.b2

    mu = tree_map(
        lambda g, m: (b1 * m.to(torch.float32) +
                      (1 - b1) * g.to(torch.float32)).to(m.dtype),
        grads, state.mu)
    nu = tree_map(
        lambda g, v: (b2 * v.to(torch.float32) + (1 - b2) *
                      torch.square(g.to(torch.float32))).to(v.dtype),
        grads, state.nu)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)

    def update(p, m, v):
        m = m.to(torch.float32)
        v = v.to(torch.float32)
        u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        u = u + run.weight_decay * p.to(torch.float32)
        return (-lr * u).to(p.dtype)

    updates = tree_map(update, params, mu, nu)
    return updates, AdamWState(step, mu, nu)


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
