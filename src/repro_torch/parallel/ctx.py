"""Activation-sharding context (the port of ``repro/parallel/ctx.py``).

The reference pins intermediate activations with sharding constraints so
that XLA's partitioner all-gathers FSDP weights rather than replicate the
batch.  ``mesh_context`` installs the active mesh (thread-local) and the
``constrain_*`` functions, which the model modules call where the
reference's do, resolve the reference's specs against it.  They return
their input unchanged when no mesh is installed or every axis has size 1
(one card).  On a mesh of several devices the activations are DTensors
and a constraint redistributes one to the resolved placements; a plain
tensor there is an error, unless the constraint places nothing.  Inside
``mesh_context`` of such a mesh, a plain tensor the model makes itself
(positions, masks, zeros) stands for a replicated one (DTensor's
``implicit_replication``).  :func:`heads_local` runs attention on each
rank's shard of the batch and the heads (``local_map``), so kernel K5
reads plain local tensors.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.sharding import placements

_STATE = threading.local()


def set_mesh(mesh: Optional[Mesh]) -> None:
    _STATE.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """``mesh`` active for the ``constrain_*`` hints; on a mesh of several
    devices plain tensors mix with DTensors as replicated ones."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        if mesh.trivial:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        set_mesh(prev)


def _clean_axis(axis, mesh: Mesh):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh.axis_names)
        return kept if kept else None
    return axis if axis in mesh.axis_names else None


def resolve(shape: Tuple[int, ...], spec, mesh: Mesh) -> Tuple:
    """The reference's constraint spec for a tensor of ``shape`` on
    ``mesh``: axes missing from the mesh are dropped, and dims whose size
    is not divisible by the target axes are left unsharded."""
    cleaned = []
    for dim, axis in zip(shape, spec):
        axis = _clean_axis(axis, mesh)
        if axis is None:
            cleaned.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        size = 1
        for a in names:
            size *= mesh.shape[a]
        cleaned.append(axis if dim % size == 0 else None)
    return tuple(cleaned)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The sharding constraint ``spec`` on ``x`` against the active mesh:
    ``x`` itself with no mesh, a spec of another rank, or a mesh whose
    every axis has size 1; else the DTensor ``x`` redistributed to the
    resolved spec (a plain tensor raises ``TypeError`` unless the spec
    places nothing: it stands for a replicated one)."""
    mesh = get_mesh()
    if mesh is None or x.dim() != len(spec) or mesh.trivial:
        return x
    resolved = resolve(tuple(x.shape), spec, mesh)
    if not isinstance(x, DTensor):
        if all(a is None for a in resolved):
            return x
        raise TypeError(
            f"placing an activation by {resolved} on the mesh "
            f"{mesh.shape} needs a DTensor, got a plain tensor")
    return x.redistribute(x.device_mesh, placements(resolved, mesh))


def gathered(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated on every rank (an all-gather of a sharded
    DTensor, whose gradient is the matching reduce-scatter); a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim)


def _placed(t: torch.Tensor, dm, pl) -> DTensor:
    """``t`` as a DTensor in placements ``pl``: a DTensor redistributed,
    a plain (replicated) tensor cut to this rank's shard."""
    if isinstance(t, DTensor):
        return t.redistribute(dm, pl)
    return distribute_tensor(t, dm, pl, src_data_rank=None)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx_, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, grad):
        return grad.contiguous()


def heads_local(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *rows: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, *rows)`` on each rank's shard: q [B, S, H, hd] and
    k/v [B, S', KH, hd] with the batch over the data axes (where it
    divides) and the heads over "model" (where H and KH both divide),
    ``rows`` ([B] tensors) split by the batch alike; the output is placed
    as q.  Plain tensors (one device, no mesh) go to ``fn`` as they
    are."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, *rows)
    mesh = get_mesh()
    m = mesh.shape.get("model", 1)
    heads = "model" if q.shape[2] % m == 0 and k.shape[2] % m == 0 \
        else None
    spec = resolve(tuple(q.shape), (batch_axes() or None, None, heads,
                                    None), mesh)
    dm = q.device_mesh
    pl, pl_rows = placements(spec, mesh), placements(spec[:1], mesh)
    qkv = [_placed(t, dm, pl) for t in (q, k, v)]
    rows = [_placed(r, dm, pl_rows) for r in rows]
    # contiguous, forward and backward: the flash path's local output and
    # its inputs' gradients are transposed views, which the DTensor ops
    # around it cannot view as their shapes
    def contiguous_fn(q, k, v, *rows):
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        return fn(q, k, v, *rows).contiguous()

    run = local_map(contiguous_fn, out_placements=pl,
                    in_placements=(pl,) * 3 + (pl_rows,) * len(rows),
                    device_mesh=dm)
    return run(*qkv, *rows)


def local_rows(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """Each rank's shard of ``cache`` [B, S, ...] (its own rows, whole
    along S), of ``new`` [B, 1, ...] placed as the cache, and of ``pos``
    [B] split by the batch alike, for a write into the cache in place:
    the local tensor is the DTensor's storage.  Plain tensors as they
    are; a cache split along S raises ``ValueError``."""
    if not isinstance(cache, DTensor):
        return cache, new, pos
    pl = cache.placements
    if any(p.is_shard(1) for p in pl):
        raise ValueError(f"a cache split along its sequence ({pl}) takes "
                         f"no local write")
    dm = cache.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in pl]
    return (cache.to_local(), _placed(new, dm, pl).to_local(),
            _placed(pos, dm, rows).to_local())


def batch_axes() -> Tuple[str, ...]:
    mesh = get_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def set_sequence_parallel(enabled: bool) -> None:
    """Megatron-style sequence parallelism for the residual stream: outside
    attention/MLP blocks, activations are sharded [batch->(pod,data),
    seq->model]."""
    _STATE.seq_parallel = enabled


def sequence_parallel() -> bool:
    return getattr(_STATE, "seq_parallel", False)


def set_expert_parallel(enabled: bool) -> None:
    _STATE.expert_parallel = enabled


def expert_parallel() -> bool:
    return getattr(_STATE, "expert_parallel", True)


@contextlib.contextmanager
def options(seq_parallel: bool = False, expert_parallel: bool = True):
    prev = sequence_parallel()
    prev_ep = globals()["expert_parallel"]()
    set_sequence_parallel(seq_parallel)
    set_expert_parallel(expert_parallel)
    try:
        yield
    finally:
        set_sequence_parallel(prev)
        set_expert_parallel(prev_ep)


def constrain_bsd(x: torch.Tensor) -> torch.Tensor:
    """Activations [B, S, D]: batch over (pod, data)."""
    return constrain(x, batch_axes() or None, None, None)


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Residual stream [B, S, D] at layer boundaries: batch over (pod,data)
    plus sequence over model when sequence parallelism is on."""
    if sequence_parallel():
        return constrain(x, batch_axes() or None, "model", None)
    return constrain_bsd(x)


def enter_block(x: torch.Tensor) -> torch.Tensor:
    """A block's input [B, S, D] with its sequence whole again: under
    sequence parallelism the residual stream is split along S, and the
    attention and MLP blocks take it gathered (Megatron's block-entry
    all-gather, which XLA inserts for the reference).  DTensor's planner
    for a product of an S-split input is too slow to let it choose."""
    if sequence_parallel():
        return constrain_bsd(x)
    return x


def exit_block(y: torch.Tensor) -> torch.Tensor:
    """A block's output [B, S, D] split along S as the residual stream it
    joins, under sequence parallelism (Megatron's reduce-scatter; its
    gradient comes back gathered along S, so the block's backward never
    views a tensor split along both B and S)."""
    if sequence_parallel():
        return constrain_residual(y)
    return y


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """Per-head activations [B, S, H, hd]: heads over model (TP)."""
    return constrain(x, batch_axes() or None, None, "model", None)


def constrain_ffn(x: torch.Tensor) -> torch.Tensor:
    """MLP hidden [B, S, F]: F over model (TP)."""
    return constrain(x, batch_axes() or None, None, "model")


def constrain_experts(x: torch.Tensor) -> torch.Tensor:
    """MoE dispatch [E, C, D]: experts over model (EP); under ep=False the
    expert dim stays replicated and TP lives inside the expert ffn."""
    if not expert_parallel():
        return x
    return constrain(x, "model", None, None)


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    """[B, S, V]: batch over (pod, data), vocab over model."""
    return constrain(x, batch_axes() or None, None, "model")
