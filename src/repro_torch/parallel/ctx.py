"""Activation-sharding context (the port of ``repro/parallel/ctx.py``).

The reference pins intermediate activations with sharding constraints so
that XLA's partitioner all-gathers FSDP weights rather than replicate the
batch.  ``mesh_context`` installs the active mesh (thread-local) and the
``constrain_*`` functions resolve the reference's specs against it.  They
return their input unchanged when no mesh is installed or every axis has
size 1 (one card).  Placing an activation on a mesh of several devices
waits for DTensor, so there they raise; the model modules do not call them
yet (ROADMAP: the multi-device slice wires them in).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh

_STATE = threading.local()


def set_mesh(mesh: Optional[Mesh]) -> None:
    _STATE.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
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
    every axis has size 1."""
    mesh = get_mesh()
    if mesh is None or x.dim() != len(spec):
        return x
    resolved = resolve(tuple(x.shape), spec, mesh)
    if mesh.trivial or all(a is None for a in resolved):
        return x
    raise NotImplementedError(
        f"placing an activation by {resolved} on the mesh "
        f"{mesh.shape} needs DTensor, which the port does not use yet")


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
