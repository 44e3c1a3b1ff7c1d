"""Weights carried across from the JAX reference.

The reference keeps parameters as a pytree of arrays with every layer
weight stacked on a leading axis; the port keeps the same tree with that
axis unrolled into a list of per-layer dicts.  :func:`params_from_reference`
maps the one onto the other, so both packages can compute with the same
weights (the tests do this; the port's own ``init`` draws from a
``torch.Generator``, whose stream differs from ``jax.random``'s).
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


def _tree(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return _tensor(node, device)


def _layer(node, i: int, device: torch.device):
    if isinstance(node, dict):
        return {k: _layer(v, i, device) for k, v in node.items()}
    return _tensor(np.asarray(node)[i], device)


def params_from_reference(params: Params, cfg: ArchConfig,
                          device=None) -> Params:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes; layers stacked on a leading axis) as the port's
    parameters on ``device`` (default: :func:`repro_torch.runtime.device`).
    Values and dtypes are kept bit for bit."""
    dev = runtime.device(device)
    out = {}
    for key, node in params.items():
        if key != "layers":
            out[key] = _tree(node, dev)
            continue
        lead = {np.asarray(leaf).shape[0] for leaf in _leaves(node)}
        if lead != {cfg.n_layers}:
            raise ValueError(f"stacked layer axis {sorted(lead)} does not "
                             f"match n_layers={cfg.n_layers}")
        out[key] = [_layer(node, i, dev) for i in range(cfg.n_layers)]
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
