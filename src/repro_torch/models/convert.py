"""Weights carried across from the JAX reference.

The reference keeps parameters as a pytree of arrays with every layer
weight of a stack stacked on a leading axis; the port keeps the same tree
with that axis unrolled into a list of per-layer dicts.  The stacks are
``layers`` (``n_layers``: transformer, hybrid), ``encoder``
(``n_encoder_layers``) and ``decoder`` (``n_layers``); everything else
(the hybrid's ``shared`` block, the xLSTM's tuple of ``blocks``) has no
stacked axis and keeps its structure.  :func:`params_from_reference` maps
the one onto the other, so both packages can compute with the same
weights (the tests do this; the port's own ``init`` draws from a
``torch.Generator``, whose stream differs from ``jax.random``'s).
:func:`state_from_reference` carries a whole training state (parameters
and AdamW moments) the same way.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]


def _tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.array(x)                   # a writable copy
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_to(node, device):
    """A tree of dicts, tuples and lists keeping its structure, its
    leaves as tensors on ``device``: a tensor moved, anything else
    (numpy, ml_dtypes' bfloat16) copied bit for bit."""
    if isinstance(node, dict):
        return {k: tree_to(v, device) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(tree_to(v, device) for v in node)
    if isinstance(node, torch.Tensor):
        return node.to(device)
    return _tensor(node, device)


def _layer(node, i: int, device: torch.device):
    if isinstance(node, dict):
        return {k: _layer(v, i, device) for k, v in node.items()}
    return _tensor(np.asarray(node)[i], device)


def params_from_reference(params: Params, cfg: ArchConfig,
                          device=None) -> Params:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes; stacks on a leading axis) as the port's
    parameters on ``device`` (default: :func:`repro_torch.runtime.device`).
    Values and dtypes are kept bit for bit."""
    dev = runtime.device(device)
    stacks = {"layers": cfg.n_layers, "encoder": cfg.n_encoder_layers,
              "decoder": cfg.n_layers}
    out = {}
    for key, node in params.items():
        if key not in stacks:
            out[key] = tree_to(node, dev)
            continue
        n = stacks[key]
        lead = {np.asarray(leaf).shape[0] for leaf in _leaves(node)}
        if lead != {n}:
            raise ValueError(f"stacked {key!r} axis {sorted(lead)} does not "
                             f"match its {n} layers")
        out[key] = [_layer(node, i, dev) for i in range(n)]
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def state_from_reference(state, cfg: ArchConfig, device=None):
    """The reference's ``TrainState`` (``params``, ``opt`` with ``step``,
    ``mu``, ``nu``; numpy arrays or anything ``np.asarray`` takes) as the
    port's :class:`repro_torch.train.loop.TrainState` on ``device``.
    The moments share the parameters' tree, so they unstack alike; values
    and dtypes are kept bit for bit."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.loop import TrainState
    dev = runtime.device(device)
    opt = state.opt
    return TrainState(
        params_from_reference(state.params, cfg, dev),
        AdamWState(_tensor(np.asarray(opt.step), dev),
                   params_from_reference(opt.mu, cfg, dev),
                   params_from_reference(opt.nu, cfg, dev)))
