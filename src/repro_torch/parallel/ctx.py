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
``implicit_replication``).  What the reference leaves to XLA's
partitioner the port runs as each rank's local computation
(``local_map``), so DTensor's planner never places the model op by op:
:func:`einsum` each weight product (Megatron's column- and row-parallel
layers), :func:`heads_local` attention on the rank's shard of the batch
and heads (kernel K5 reads plain local tensors), :func:`batch_local` the
recurrences on its shard of the batch, :func:`replicated_local` the MoE
routing every rank computes whole; :func:`cache_zeros`,
:func:`write_prefix`, :func:`set_layer` and :func:`local_rows` write a
cache through each rank's shard.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)
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


def _placed(t: torch.Tensor, dm, pl) -> DTensor:
    """``t`` as a DTensor in placements ``pl``: a DTensor redistributed
    (itself if already so placed: a no-op redistribution would reduce a
    partial gradient at every use of a weight instead of once), a plain
    (replicated) tensor cut to this rank's shard."""
    if isinstance(t, DTensor):
        if tuple(t.placements) == tuple(pl):
            return t
        return t.redistribute(dm, pl)
    return distribute_tensor(t, dm, pl, src_data_rank=None)


class _GatheredWeight(torch.autograd.Function):
    """A weight redistributed to the placements its local product needs;
    its gradient returned as the product leaves it (a partial sum where
    the activations were split), so every use of a weight (a tied
    embedding's lookup and unembedding) adds into one gradient, which
    the train step reduces once to the weight's placements
    (``loop._placed_as``): a redistribution's own backward would reduce
    it at every use."""

    @staticmethod
    def forward(ctx_, w, dm, pl):
        return w.redistribute(dm, pl)

    @staticmethod
    def backward(ctx_, grad):
        return grad, None, None


def _weight(w: torch.Tensor, dm, pl) -> DTensor:
    """A weight as a DTensor in placements ``pl`` (see _GatheredWeight)."""
    if isinstance(w, DTensor) and tuple(w.placements) != tuple(pl):
        return _GatheredWeight.apply(w, dm, pl)
    return _placed(w, dm, pl)


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


def batch_local(fn, acts, weights=(), n_out: int = 1):
    """``fn(*acts, *weights)`` on each rank's shard of the batch: every
    tensor of ``acts`` split along its first dim by the batch axes (where
    it divides) and whole along the rest, every tensor of ``weights``
    whole; the ``n_out`` outputs (dim 0 the batch) placed as the
    activations, the weights' gradients partial sums over the batch
    axes.  For the recurrences (the scans, the sLSTM's loop over time),
    whose every op DTensor's planner would otherwise place one by one.
    Plain tensors (one device, no mesh) go to ``fn`` as they are."""
    first = _first_dtensor(acts, weights)
    if first is None:
        return fn(*acts, *weights)
    spec = resolve((acts[0].shape[0],), (batch_axes() or None,),
                   get_mesh())
    return _run_local(fn, first.device_mesh,
                      list(placements(spec, get_mesh())), acts, weights,
                      n_out)


def replicated_local(fn, acts, n_out: int = 1):
    """``fn(*acts)`` on every rank whole: the inputs gathered, the
    outputs replicated (the MoE's global routing, dispatch and combine,
    which every rank computes for every token, as the reference's
    single-program partition does).  Plain tensors go to ``fn`` as they
    are."""
    first = _first_dtensor(acts, ())
    if first is None:
        return fn(*acts)
    dm = first.device_mesh
    return _run_local(fn, dm, [Replicate()] * dm.ndim, acts, (), n_out)


def _first_dtensor(acts, weights) -> Optional[DTensor]:
    return next((t for t in (*acts, *weights) if isinstance(t, DTensor)),
                None)


def _run_local(fn, dm, pl_act, acts, weights, n_out):
    """``fn`` under ``local_map``: ``acts`` placed ``pl_act`` (a list:
    local_map reads a tuple as one placement an output), ``weights``
    replicated with gradients summed where ``pl_act`` splits; the
    outputs placed ``pl_act``; every float tensor made contiguous in and
    out (DTensor's views refuse the transposed local views of einsum and
    K5)."""
    pl_w = [Replicate()] * dm.ndim
    pl_wgrad = [Partial() if p.is_shard() else Replicate() for p in pl_act]
    acts = [_placed(t, dm, pl_act) for t in acts]
    weights = [_weight(w, dm, pl_w) for w in weights]

    def contiguous_fn(*args):
        args = [_ContiguousGrad.apply(a) if a.is_floating_point() else a
                for a in args]
        out = fn(*args)
        if n_out == 1:
            return out.contiguous()
        return tuple(o.contiguous() for o in out)

    run = local_map(contiguous_fn,
                    out_placements=pl_act if n_out == 1 else
                    (pl_act,) * n_out,
                    in_placements=(pl_act,) * len(acts) +
                    (pl_w,) * len(weights),
                    in_grad_placements=(pl_act,) * len(acts) +
                    (pl_wgrad,) * len(weights), device_mesh=dm)
    return run(*acts, *weights)


def _letter(eq_in: str, p: Placement) -> Optional[str]:
    return eq_in[p.dim] if p.is_shard() else None


def einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight
    ``w``; on DTensors, each rank's product of its own shards under
    ``local_map`` (Megatron's column- and row-parallel layers), so
    DTensor's planner never views a split dim merged with another.  Mesh
    dim by mesh dim: a weight split along a letter other than the one
    that splits ``x`` is gathered there (FSDP's all-gather); a letter
    split in one operand and present in the other is split in both (a
    local slice, no message); a split contracted letter leaves the output
    a partial sum, which the next constraint reduces.  The gradients are
    placed alike: partial sums where an operand was replicated against a
    split letter of the other."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return torch.einsum(eq, x, w)
    ins, out = eq.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    dm = (x if isinstance(x, DTensor) else w).device_mesh
    rep = [Replicate()] * dm.ndim
    px = list(x.placements) if isinstance(x, DTensor) else rep
    pw = list(w.placements) if isinstance(w, DTensor) else rep
    tx, tw, to, gx, gw = [], [], [], [], []
    for a, b in zip(px, pw):
        a = Replicate() if a.is_partial() else a
        b = Replicate() if b.is_partial() else b
        ca, cb = _letter(lx, a), _letter(lw, b)
        if cb is not None and cb != ca and (ca is not None or cb in lx):
            b, cb = Replicate(), None          # gather the weight here
        if ca is not None and cb is None and ca in lw:
            b, cb = Shard(lw.index(ca)), ca    # slice the weight alike
        split = ca or cb
        o = Replicate() if split is None else \
            Shard(out.index(split)) if split in out else Partial()
        tx.append(a)
        tw.append(b)
        to.append(o)
        gx.append(Partial() if a.is_replicate() and cb is not None else a)
        gw.append(Partial() if b.is_replicate() and ca is not None else b)
    x, w = _placed(x, dm, tx), _weight(w, dm, tw)

    def local(x, w):
        y = torch.einsum(eq, _ContiguousGrad.apply(x),
                         _ContiguousGrad.apply(w))
        return y if y.is_contiguous() else y.contiguous()

    return local_map(local, out_placements=to, in_placements=(tx, tw),
                     in_grad_placements=(gx, gw), device_mesh=dm)(x, w)


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


def cache_zeros(shapes: Dict[str, Tuple[int, ...]], dtype, like: torch.Tensor,
                cfg, batch: int) -> Dict[str, torch.Tensor]:
    """Zeros of ``shapes`` (name -> the reference's stacked cache shape)
    on ``like``'s device; when ``like`` is a DTensor, DTensors placed by
    the cache rules (``sharding.cache_shardings``), each rank holding
    only its own shard."""
    if not isinstance(like, DTensor):
        return {k: torch.zeros(s, dtype=dtype, device=like.device)
                for k, s in shapes.items()}
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.parallel.sharding import cache_shardings
    mesh, dm = get_mesh(), like.device_mesh
    specs = cache_shardings({k: torch.empty(s, device="meta")
                             for k, s in shapes.items()}, mesh, batch, cfg)
    out = {}
    for k, s in shapes.items():
        pl = placements(specs[k], mesh)
        with unset_fake_temporarily():   # the mesh's coordinates, real
            local, _ = compute_local_shape_and_global_offset(s, dm, pl)
        out[k] = DTensor.from_local(
            torch.zeros(local, dtype=dtype, device=like.device), dm, pl,
            run_check=False, shape=torch.Size(s),
            stride=torch.empty(s, device="meta").stride())
    return out


def _local_write(cache: DTensor, new: torch.Tensor, what: str):
    """``cache``'s local shard and ``new`` placed as one entry of its
    leading dim (a cache split along that dim, or along the sequence
    when ``what`` says so, raises ``ValueError``)."""
    pl = cache.placements
    bad = (0, 2) if what == "prefix" else (0,)
    if any(p.is_shard(d) for p in pl for d in bad):
        raise ValueError(f"a cache placed {pl} takes no local {what} "
                         f"write")
    rows = [Shard(p.dim - 1) if p.is_shard() else Replicate() for p in pl]
    local = _placed(new, cache.device_mesh, rows).to_local()
    return cache.to_local(), local.to(cache.dtype)


def set_layer(cache: torch.Tensor, i: int, new: torch.Tensor) -> None:
    """``cache[i] = new`` in place (a recurrent state of layer ``i`` into
    its stacked [L, B, ...] cache); a DTensor cache through each rank's
    own shard, ``new`` placed alike."""
    if not isinstance(cache, DTensor):
        cache[i] = new
        return
    local, new = _local_write(cache, new, "layer")
    local[i] = new


def write_prefix(cache: torch.Tensor, i: int, new: torch.Tensor) -> None:
    """``cache[i, :, :S] = new`` in place, ``new`` [B, S, ...] (a prefill's
    keys or values of layer ``i`` into the stacked [L, B, max_len, ...]
    cache); a DTensor cache through each rank's own shard, ``new`` placed
    alike (a cache split along L or the sequence raises ``ValueError``)."""
    s = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[i, :, :s] = new
        return
    local, new = _local_write(cache, new, "prefix")
    local[i, :, :s] = new


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
