"""Sharding rules: logical tensor axes -> mesh axes, with divisibility
fallback chains (the port of ``repro/parallel/sharding.py``).

The rules are the reference's, as pure functions: a spec is a tuple with
one entry a tensor dimension, a mesh axis name (or a tuple of names) or
``None``, as a ``PartitionSpec`` reads.  Strategy:

* TP ("model" axis): attention q-heads (fallback head_dim), MLP hidden,
  MoE expert axis (EP), vocab (fallback embed dim), mamba/xlstm inner dim.
* FSDP ("data" axis): parameters additionally sharded along their largest
  remaining dim within a pod (hierarchical ZeRO-3).
* batch: ("pod", "data"); long-context caches: sequence over "data" when
  the batch axis cannot be split (context parallelism).

The reference stacks each layer weight on a leading axis (``[L, ...]``);
the port keeps a list of per-layer dicts.  A per-layer tensor's spec is
computed on the reference's stacked shape ``(L,) + shape`` under the
reference's path (``layers/attn/wq``) and its leading entry dropped, so
both packages choose the same axes for every weight.  On a mesh of
several devices :func:`place` puts a tree on the mesh's ``DeviceMesh`` as
DTensors by these specs (:func:`placements`) and :func:`full` gathers it
back; on one card every axis has size 1 and :func:`check_realisable` is
all a trainer does.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh

Params = Any
Spec = Tuple[Any, ...]

#: params smaller than this stay replicated (FSDP gather overhead dominates)
FSDP_MIN_ELEMS = 1 << 16

#: the parameter subtrees the reference stacks on a leading layer axis
STACKED = ("layers", "encoder", "decoder")


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _divisible(dim: int, mesh: Mesh, axis: str) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ---------------------------------------------------------------------------
# Per-leaf rules.  Each rule gives, per tensor dim counted FROM THE END,
# an ordered preference of mesh-axis candidates; the first divisible one
# wins, otherwise the dim is unsharded.  Dims not listed are unsharded
# (covers the stacked leading layer dim).
# ---------------------------------------------------------------------------
_RULES: Tuple[Tuple[str, Dict[int, Tuple[str, ...]]], ...] = (
    # attention projections [.., D, H|K, hd]
    (r"(^|/)(attn|xattn)/w[qkv]$", {-2: ("model",), -1: ("model",),
                                    -3: ("data",)}),
    (r"(^|/)(attn|xattn)/b[qkv]$", {-2: ("model",), -1: ("model",)}),
    (r"(^|/)(attn|xattn)/wo$", {-3: ("model",), -2: ("model",),
                                -1: ("data",)}),
    # MoE expert weights [.., E, D, F] / [.., E, F, D]: EP on E, FSDP inside
    (r"(^|/)moe/w_(gate|up)$", {-3: ("model",), -2: ("data",)}),
    (r"(^|/)moe/w_down$", {-3: ("model",), -2: ("data",)}),
    # no-EP variant (ep=False rewrites moe/ paths to dmoe/): experts
    # replicated across model; TP shards the ffn dim, FSDP the d dim
    (r"(^|/)dmoe/w_(gate|up)$", {-1: ("model",), -2: ("data",)}),
    (r"(^|/)dmoe/w_down$", {-2: ("model",), -1: ("data",)}),
    (r"(^|/)moe/router$", {-2: ("data",)}),
    # dense MLP [.., D, F] / [.., F, D]
    (r"(^|/)mlp/w_(gate|up)$", {-1: ("model",), -2: ("data",)}),
    (r"(^|/)mlp/w_down$", {-2: ("model",), -1: ("data",)}),
    # embeddings
    (r"(^|/)embed/tok$", {-2: ("model",), -1: ("data",)}),
    (r"(^|/)embed/head$", {-1: ("model",), -2: ("data",)}),
    # mamba2
    (r"(^|/)mamba/in_proj$", {-1: ("model",), -2: ("data",)}),
    (r"(^|/)mamba/out_proj$", {-2: ("model",), -1: ("data",)}),
    (r"(^|/)mamba/conv_w$", {-1: ("model",)}),
    # xlstm blocks
    (r"(^|/)mlstm/up_proj$", {-1: ("model",), -2: ("data",)}),
    (r"(^|/)mlstm/down_proj$", {-2: ("model",), -1: ("data",)}),
    (r"(^|/)mlstm/w[qkv]$", {-2: ("model",), -1: ("model",),
                             -3: ("data",)}),
    (r"(^|/)mlstm/w_[if]gate$", {-2: ("data",)}),
    (r"(^|/)slstm/w_in$", {-1: ("model",), -4: ("data",)}),
    (r"(^|/)slstm/r$", {-1: ("model",)}),
    (r"(^|/)slstm/out_proj$", {-2: ("model",), -1: ("data",)}),
)


def spec_for_param(path_str: str, shape: Tuple[int, ...], mesh: Mesh,
                   fsdp: bool = True, ep: bool = True) -> Spec:
    """Resolve one parameter's spec under the fallback chain.

    ``fsdp=False`` drops the "data"-axis (ZeRO-3) candidates: params are
    TP-sharded only and replicated across data.  ``ep=False`` switches MoE
    expert weights from expert-parallel (model axis on E) to
    TP-inside-experts (model axis on d_ff)."""
    if not ep:
        path_str = path_str.replace("moe/", "dmoe/")
    if len(shape) == 0 or _prod(shape) < FSDP_MIN_ELEMS and len(shape) <= 1:
        return ()
    spec: list = [None] * len(shape)
    used_axes = set()
    matched = False
    for pattern, dims in _RULES:
        if re.search(pattern, path_str):
            matched = True
            # model assignments first, so FSDP takes what is left
            order = sorted(dims.items(),
                           key=lambda kv: 0 if "model" in kv[1] else 1)
            for neg_idx, candidates in order:
                if -neg_idx > len(shape):
                    continue
                idx = len(shape) + neg_idx
                if spec[idx] is not None:
                    continue
                for axis in candidates:
                    if axis in used_axes or axis not in mesh.axis_names:
                        continue
                    if axis == "data" and (not fsdp or
                                           _prod(shape) < FSDP_MIN_ELEMS):
                        continue
                    if _divisible(shape[idx], mesh, axis):
                        spec[idx] = axis
                        used_axes.add(axis)
                        break
            break
    if not matched:
        # generic fallback: big tensors get model on the last divisible dim
        if _prod(shape) >= FSDP_MIN_ELEMS and len(shape) >= 2:
            for idx in range(len(shape) - 1, -1, -1):
                if "model" in mesh.axis_names and \
                        _divisible(shape[idx], mesh, "model"):
                    spec[idx] = "model"
                    break
    return tuple(spec)


def _map_specs(node, path: str, stack: Optional[int], fn):
    """``fn(path, logical_shape, stack)`` at every tensor leaf of ``node``,
    keeping its structure.  Inside a stacked subtree (a list of per-layer
    dicts under one of :data:`STACKED`) the path drops the layer index and
    the shape gains the reference's leading layer axis."""
    join = (lambda k: f"{path}/{k}") if path else (lambda k: str(k))
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if stack is None and not path and k in STACKED and \
                    isinstance(v, list):
                out[k] = [_map_specs(layer, k, len(v), fn) for layer in v]
            else:
                out[k] = _map_specs(v, join(k), stack, fn)
        return out
    if isinstance(node, (list, tuple)):
        return type(node)(_map_specs(v, join(i), stack, fn)
                          for i, v in enumerate(node))
    shape = tuple(node.shape)
    if stack is not None:
        shape = (stack,) + shape
    return fn(path, shape, stack)


def param_shardings(params: Params, mesh: Mesh, fsdp: bool = True,
                    ep: bool = True) -> Params:
    """A tree of specs matching ``params`` (tensors, on any device, the
    meta device too).  A per-layer tensor's spec is the reference's spec
    of the stacked tensor without its leading (layer) entry."""

    def leaf(path, shape, stack):
        spec = spec_for_param(path, shape, mesh, fsdp=fsdp, ep=ep)
        return spec[1:] if stack is not None else spec

    return _map_specs(params, "", None, leaf)


def state_shardings(state: Any, mesh: Mesh, fsdp: bool = True,
                    ep: bool = True) -> Any:
    """TrainState = (params, AdamWState(step, mu, nu)); Adam moments follow
    the params' specs exactly (same tree structure)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.loop import TrainState
    return TrainState(
        param_shardings(state.params, mesh, fsdp=fsdp, ep=ep),
        AdamWState((), param_shardings(state.opt.mu, mesh, fsdp=fsdp, ep=ep),
                   param_shardings(state.opt.nu, mesh, fsdp=fsdp, ep=ep)))


def check_realisable(specs: Any, tree: Any, mesh: Mesh) -> int:
    """Check every spec of ``specs`` against the tensor of ``tree`` it
    belongs to: one entry a dimension, every named axis on ``mesh``, no
    axis twice, each dimension divisible by the product of its axes'
    sizes.  Returns the number of tensors checked; raises ``ValueError``
    on the first spec that ``mesh`` cannot place."""
    if isinstance(tree, dict):
        return sum(check_realisable(specs[k], v, mesh)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(check_realisable(s, v, mesh)
                   for s, v in zip(specs, tree))
    shape = tuple(tree.shape)
    if specs and len(specs) != len(shape):
        raise ValueError(f"spec {specs} for a tensor of shape {shape}")
    seen = []
    for dim, entry in zip(shape, specs):
        names = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for name in names:
            if name not in mesh.axis_names or name in seen:
                raise ValueError(f"spec {specs}: axis {name!r} is not on "
                                 f"the mesh {mesh.axis_names} or repeats")
            seen.append(name)
            size *= mesh.shape[name]
        if dim % size:
            raise ValueError(f"spec {specs}: dimension {dim} of {shape} "
                             f"does not split {size} ways")
    return 1


# ---------------------------------------------------------------------------
# Placing trees on a DeviceMesh (DTensor)
# ---------------------------------------------------------------------------
def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh: Mesh) -> List[Placement]:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim ``i`` gets
    ``Shard(d)`` when its axis name appears at tensor dim ``d``, else
    ``Replicate()``.  A dim split over several axes is split in mesh
    order (DTensor's), so an entry must list its axes in that order, as
    the rules do (``("pod", "data")``); one listed otherwise, or an axis
    named twice, raises ``ValueError``."""
    order = {name: i for i, name in enumerate(mesh.axis_names)}
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = _names(entry)
        if any(n not in order for n in names):
            raise ValueError(f"spec {spec}: {names} not all on the mesh "
                             f"{mesh.axis_names}")
        if [order[n] for n in names] != sorted(order[n] for n in names):
            raise ValueError(f"spec {spec}: {names} is not in the mesh's "
                             f"axis order {mesh.axis_names}")
        for n in names:
            if n in dim_of:
                raise ValueError(f"spec {spec}: axis {n!r} named twice")
            dim_of[n] = d
    return [Shard(dim_of[n]) if n in dim_of else Replicate()
            for n in mesh.axis_names]


def _map_leaves(fn, tree, specs=None):
    """``fn(leaf, spec)`` over a tree of NamedTuples, dicts, lists and
    tuples whose leaves are tensors, ``specs`` its tree of specs (``None``:
    every spec ``None``)."""
    def sub(key):
        return None if specs is None else specs[key]

    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v, sub(i))
                            for i, v in enumerate(tree)))
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, sub(i))
                          for i, v in enumerate(tree))
    return fn(tree, specs)


def place(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor on ``mesh.device_mesh()``,
    placed by its spec.  Every rank holds the same values (the same seed,
    checkpoint or step of the pipeline), so each keeps its own shard and
    nothing is sent."""
    dm = mesh.device_mesh()

    def leaf(t, spec):
        if isinstance(t, DTensor):
            raise ValueError("place() takes whole tensors, not DTensors")
        return distribute_tensor(t, dm, placements(spec, mesh),
                                 src_data_rank=None)

    return _map_leaves(leaf, tree, specs)


def full(tree: Any) -> Any:
    """``tree`` with every DTensor leaf gathered into a whole tensor on
    its rank's device (a collective: every rank calls it); other leaves
    as they are."""
    return _map_leaves(lambda t, _: t.full_tensor()
                       if isinstance(t, DTensor) else t, tree)


# ---------------------------------------------------------------------------
# Activations / inputs / caches
# ---------------------------------------------------------------------------
def batch_sharding(mesh: Mesh, batch_size: int, ndim: int = 2) -> Spec:
    """tokens/labels [B, S] (or [B] for decode): batch over (pod, data)."""
    axes = data_axes(mesh)
    total = _prod(mesh.shape[a] for a in axes)
    first = None
    if axes and batch_size % total == 0:
        first = axes if len(axes) > 1 else axes[0]
    return tuple([first] + [None] * (ndim - 1))


def embeds_sharding(mesh: Mesh, batch_size: int) -> Spec:
    axes = data_axes(mesh)
    total = _prod(mesh.shape[a] for a in axes)
    first = axes if batch_size % max(total, 1) == 0 and axes else None
    if first is not None and len(first) == 1:
        first = first[0]            # as PartitionSpec spells one axis
    return (first, None, None)


def cache_shardings(cache: Params, mesh: Mesh, batch: int,
                    cfg: ArchConfig) -> Params:
    """KV / SSM-state caches (the port keeps the reference's stacked cache
    layout, so the rule is the reference's as it is).

    Preference: batch over (pod,data) when divisible; otherwise shard the
    *sequence* dim over "data" (context parallelism for long_500k b=1).
    Heads/state dims go on "model" when divisible."""
    axes = data_axes(mesh)
    total = _prod(mesh.shape[a] for a in axes)
    batch_ok = bool(axes) and batch % total == 0

    def leaf(path_str, shape, _stack):
        spec: list = [None] * len(shape)
        # the batch dim: the first dim equal to batch (after any leading
        # stacking dims); KV caches are [L|apps, B, S, K, hd], ssm states
        # [L, B, ...]
        b_idx = shape.index(batch) if batch in shape else -1
        if b_idx >= 0 and batch_ok:
            spec[b_idx] = axes if len(axes) > 1 else axes[0]
        is_kv = re.search(r"(^|/)(k|v|xk|xv)$", path_str) is not None
        if is_kv and len(shape) >= 4:
            # [.., B, S, K, hd]
            if not (b_idx >= 0 and batch_ok) and \
                    "data" in mesh.axis_names and \
                    _divisible(shape[-3], mesh, "data"):
                spec[-3] = "data"  # context parallelism over sequence
            if _divisible(shape[-2], mesh, "model"):
                spec[-2] = "model"
            elif _divisible(shape[-1], mesh, "model"):
                spec[-1] = "model"
        elif len(shape) >= 2:
            # ssm states [.., B, h, n, p] etc: shard a head/state dim
            for idx in range(len(shape) - 1, max(b_idx, 0), -1):
                if spec[idx] is None and \
                        _divisible(shape[idx], mesh, "model") and \
                        shape[idx] >= _axis_size(mesh, "model"):
                    spec[idx] = "model"
                    break
        return tuple(spec)

    return _map_specs(cache, "", None, leaf)
