"""Multi-pod dry run: every (arch x shape x mesh) cell counted on a fake
process group (the port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step on 512 forced XLA
host devices and reads XLA's ``cost_analysis``.  The port runs the step
itself, once, on a ``fake`` process group (``torch.testing._internal.
distributed.fake_pg``) of the production mesh's world size, this process
its rank 0: the state, batch and cache are DTensors placed by the
sharding rules whose local shards are fake tensors (``FakeTensorMode``,
on the ``cpu`` or ``cuda`` device) or meta tensors, so nothing is
stored and no collective moves data.  For each cell:

* a FULL count of the step at full depth on the requested mesh;
* two PROBE counts (the reference's layer counts, ``scan_unroll``) on the
  single-pod mesh and their linear extrapolation f(L) = a + b L, as the
  reference's; the port runs no ``lax.scan``, so the full count is the
  whole step too, and the two can be held against each other;
* the three roofline terms on a hardware profile (``core/hardware.
  H100_SXM`` by default, ``TPU_V5E`` for the reference's), beside the
  Distributed Data Calculator's predicted terms.

The counts are per chip, as XLA's ``cost_analysis`` of an SPMD program
is:

* ``flops``: the matrix FLOPs of the ops rank 0 runs on its local
  shards, by ``torch.utils.flop_counter``'s formulas (kernel K5 by its
  own: ``4 B H D`` x the kept (query, key) pairs), replicated work in
  full.  A ``FlopCounterMode`` around DTensor ops would count the global
  op (a ``[64, 1024] @ [1024, 1024]`` split ``(Shard(0), Shard(1))`` on
  a (16, 16) mesh counts 1.34e8 where each chip does 5.2e5): the counter
  here lets DTensor dispatch each op and counts the local ops it runs,
  and none of its sharding propagation's shape inference.  Elementwise
  ops count no FLOPs (XLA's figure counts them).
* ``bytes_accessed``: the local input plus output bytes of every op that
  writes a tensor and is not a view, an unfused upper bound (XLA's
  figure is after fusion).
* ``collectives``: the result bytes of each functional collective by
  kind, and the bytes a chip moves by the ring factors the reference's
  ``collective_bytes`` states: all-reduce 2x its result, reduce-scatter
  its result x the group (its input is the full buffer), 1x the others.
  The reference parses the HLO text; the port reads the collectives as
  they are issued, so that parser has no twin.
* ``memory``: the local bytes of the step's arguments and outputs; the
  peak of temporaries is not tracked (``temp_size_in_bytes`` is None).

Records are JSON files, one a cell, under a directory of the temporary
directory by default (``experiments/dryrun/`` is the reference's), so
the sweep is resumable.  Each cell of ``--all`` runs in a subprocess of
its own (one fake process group a process); a failed cell is written as
an ``error`` record and the CLI exits non-zero.  Run:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh both --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import runtime
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (ArchConfig, RunConfig, SHAPES,
                                      ShapeConfig, shape_applies)
from repro_torch.core import distcalc
from repro_torch.core.hardware import H100_SXM, TPU_V5E, TPUProfile
# registers K5's op, its fake implementation and its flop formula
from repro_torch.kernels.flash_attention import ops as _flash_ops  # noqa
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.models import build
from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import (_map_leaves, batch_sharding,
                                           cache_shardings, embeds_sharding,
                                           param_shardings, place,
                                           state_shardings)
from repro_torch.train.loop import init_state, make_train_step
from repro_torch.train.serve import make_prefill_step, make_serve_step

OUT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_dryrun")

#: probe layer counts per family pattern period
PROBE_PERIOD = {"dense": 2, "moe": 2, "vlm": 2, "audio": 2,
                "hybrid": 6, "ssm": 4}

#: the devices a cell's tensors may stand on: fake tensors of the cpu or
#: cuda device, or meta tensors (no FakeTensorMode: the same FLOPs in
#: about half the seconds)
DEVICES = ("cpu", "meta", "cuda")


# ---------------------------------------------------------------------------
# input_specs: shape and dtype stand-ins for every model input
# ---------------------------------------------------------------------------
class TensorSpec(NamedTuple):
    """A tensor's shape and dtype (``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str,
                                                              TensorSpec]:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"token": TensorSpec((b,), i32),
                "pos": TensorSpec((b,), i32)}
    if cfg.family == "audio":
        # half source frames, half target tokens (total = seq_len)
        return {"tokens": TensorSpec((b, s // 2), i32),
                "labels": TensorSpec((b, s // 2), i32),
                "embeds": TensorSpec((b, s // 2, cfg.d_model),
                                     torch.float32)}
    if cfg.family == "vlm":
        txt = s - cfg.n_patches
        return {"tokens": TensorSpec((b, txt), i32),
                "labels": TensorSpec((b, txt), i32),
                "embeds": TensorSpec((b, cfg.n_patches, cfg.d_model),
                                     torch.float32)}
    return {"tokens": TensorSpec((b, s), i32),
            "labels": TensorSpec((b, s), i32)}


def _batch_shardings(specs: Dict[str, TensorSpec], mesh: Mesh,
                     batch: int) -> Dict:
    return {key: embeds_sharding(mesh, batch) if key == "embeds" else
            batch_sharding(mesh, batch, ndim=len(spec.shape))
            for key, spec in specs.items()}


# ---------------------------------------------------------------------------
# Lower one cell: its step and placed abstract inputs
# ---------------------------------------------------------------------------
#: per-chip activation-stash budget driving the microbatch policy (bytes)
STASH_BUDGET = 2 << 30


def pick_microbatch(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                    seq_parallel: bool) -> int:
    """Gradient-accumulation policy: smallest number of microbatches such
    that the per-chip remat stash (one [b_micro, S, D] residual per layer)
    fits the budget.  Microbatch size must stay divisible by the dp ways."""
    sizes = mesh.shape
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    sp = sizes.get("model", 1) if seq_parallel and \
        shape.seq_len % sizes.get("model", 1) == 0 else 1
    cb = 2 if cfg.compute_dtype == "bfloat16" else 4
    layers = cfg.n_layers + cfg.n_encoder_layers
    micro = shape.global_batch
    while micro > dp:
        stash = micro * shape.seq_len * cfg.d_model * cb * layers / (dp * sp)
        if stash <= STASH_BUDGET:
            break
        micro //= 2
    return max(micro, min(dp, shape.global_batch))


@dataclasses.dataclass
class Cell:
    """A lowered cell: its step (``fn()`` runs it once), the placed
    abstract arguments, and the mesh and options it runs under."""

    fn: Any
    args: Any
    mesh: Mesh
    seq_parallel: bool
    ep: bool
    tensor_mode: Any                    # a FakeTensorMode, or None (meta)

    @contextlib.contextmanager
    def running(self):
        with contextlib.ExitStack() as stack:
            if self.tensor_mode is not None:
                stack.enter_context(self.tensor_mode)
            stack.enter_context(ctx.mesh_context(self.mesh))
            stack.enter_context(ctx.options(seq_parallel=self.seq_parallel,
                                            expert_parallel=self.ep))
            yield


def abstract(tree, device: str):
    """Every leaf of ``tree`` (meta tensors) as an empty tensor of its
    shape and dtype on ``device`` (fake inside a FakeTensorMode)."""
    return _map_leaves(lambda t, _: torch.empty(
        t.shape, dtype=t.dtype, device=device), tree)


def _placed(tree, specs, mesh: Mesh):
    return tree if mesh.trivial else place(tree, specs, mesh)


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
               seq_parallel: Optional[bool] = None,
               microbatch: Optional[int] = None,
               fsdp: bool = True,
               ep: bool = True,
               moment_dtype: str = "float32",
               grad_compression: bool = False,
               device: str = "cuda", src_len: int = 4096) -> Cell:
    """The cell's step and its abstract inputs on ``mesh``: a mesh of
    several devices needs an initialised process group of its size (see
    :func:`fake_process_group`); on a one-device mesh the inputs are
    plain tensors, as one card runs them.  ``src_len`` is an
    encoder-decoder's cached source length in a decode cell (the
    reference's 4,096)."""
    if device not in DEVICES:
        raise ValueError(f"device {device!r} is not one of {DEVICES}")
    if device != "meta":
        runtime.device(device)           # cuda without a card raises
    model = build(cfg)
    sp = shape.kind == "train" if seq_parallel is None else seq_parallel
    if not mesh.trivial:
        mesh.device_mesh()               # built outside the fake mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = None if device == "meta" else FakeTensorMode()
    b = shape.global_batch
    specs = input_specs(cfg, shape)
    with mode if mode is not None else contextlib.nullcontext():
        inputs = {k: torch.empty(s.shape, dtype=s.dtype, device=device)
                  for k, s in specs.items()}

        if shape.kind == "train":
            micro = pick_microbatch(cfg, shape, mesh, sp) \
                if microbatch is None else microbatch
            run = RunConfig(microbatch=micro,
                            grad_compression=grad_compression)
            meta = init_state(model, 0, device="meta",
                              moment_dtype=getattr(torch, moment_dtype))
            state = _placed(abstract(meta, device),
                            state_shardings(meta, mesh, fsdp=fsdp, ep=ep),
                            mesh)
            batch = _placed(inputs, _batch_shardings(specs, mesh, b), mesh)
            step = make_train_step(model, run)
            return Cell(lambda: step(state, batch), (state, batch), mesh,
                        sp, ep, mode)

        meta = model.init(0, device="meta")
        params = _placed(abstract(meta, device),
                         param_shardings(meta, mesh, fsdp=fsdp, ep=ep), mesh)
        if shape.kind == "prefill":
            args = _placed(inputs, _batch_shardings(specs, mesh, b), mesh)
            step = make_prefill_step(model, max_len=shape.seq_len)

            def prefill():
                with torch.no_grad():
                    return step(params, args.get("tokens"),
                                embeds=args.get("embeds"))

            return Cell(prefill, (params, args), mesh, sp, ep, mode)

        kw = {"src_len": src_len} if cfg.family == "audio" else {}
        meta_cache = model.init_cache(b, shape.seq_len, device="meta", **kw)
        cache = _placed(abstract(meta_cache, device),
                        cache_shardings(meta_cache, mesh, b, cfg), mesh)
        rows = _placed(inputs, {k: batch_sharding(mesh, b, ndim=1)
                                for k in inputs}, mesh)
        serve = make_serve_step(model)

        def decode():
            with torch.no_grad():
                return serve(params, cache, rows["token"], rows["pos"])

        return Cell(decode, (params, cache, rows), mesh, False, ep, mode)


@contextlib.contextmanager
def fake_process_group(world: int):
    """A ``fake`` process group of ``world`` ranks, this process its rank
    0, destroyed on exit (nothing is sent: collectives return their
    buffers untouched)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Cost extraction
# ---------------------------------------------------------------------------
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
#: functional collectives -> the reference's HLO kinds (another kind is
#: kept under its own name)
_FUNCOL_KIND = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
#: the functional collectives that only wait for one issued before
_FUNCOL_WAITS = ("wait_tensor", "_wrap_tensor_autograd")

#: ops that return a view though their schema does not mark it
_ALIASING = {torch.ops.aten._unsafe_view.default,
             torch.ops.aten.lift_fresh.default}

_PROPAGATING = threading.local()


#: DTensor's shape inference on global fake tensors, the first of these
#: methods its ShardingPropagator has (they differ across torch
#: versions): the counter skips what runs inside it
_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                "_propagate_tensor_meta")


@contextlib.contextmanager
def _marking_propagation():
    """DTensor's sharding propagation marked while it runs (the ops of
    its shape inference are no chip's work)."""
    name = next(n for n in _PROPAGATION if hasattr(ShardingPropagator, n))
    inner = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    total = 0
    for t in leaves:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


class CostCounter(TorchDispatchMode):
    """Counts, per chip, the FLOPs and bytes of the ops this rank runs
    on its local tensors and the bytes of the collectives it issues.  An
    op on DTensors is handed back to DTensor (``NotImplemented``), which
    redistributes and runs the local op with this mode still active."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll_bytes = {k: 0.0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.moved = 0.0
        self._marking = None

    def __enter__(self):
        self._marking = _marking_propagation()
        self._marking.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marking.__exit__(None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_PROPAGATING, "depth", 0):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional":
            if name not in _FUNCOL_WAITS:
                kind = _FUNCOL_KIND.get(name, name)
                result = _nbytes(out)
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + \
                    result
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
                factor = {"all-reduce": 2.0,
                          "reduce-scatter": float(args[2])}.get(kind, 1.0)
                self.moved += factor * result
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        written = _nbytes(out)
        if written and not func.is_view and func not in _ALIASING:
            self.ops += 1
            self.bytes += _nbytes((args, kwargs)) + written
        return out

    def costs(self) -> Dict[str, Any]:
        """The counts so far; ``local_ops`` the ops that wrote a tensor
        (the launches an eager run on the card makes, give or take)."""
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes),
                "collectives": {"per_kind_result_bytes": dict(self.coll_bytes),
                                "counts": dict(self.coll_counts),
                                "moved_bytes_per_chip": self.moved},
                "local_ops": self.ops}


def extract_costs(cell: Cell) -> Dict[str, Any]:
    """Runs the cell's step once under :class:`CostCounter`: the per-chip
    ``flops``, ``bytes_accessed``, ``collectives`` and ``memory``."""
    counter = CostCounter()
    t0 = time.perf_counter()
    with cell.running(), counter:
        out = cell.fn()
    costs = counter.costs()
    costs["seconds"] = time.perf_counter() - t0
    costs["memory"] = {
        "argument_size_in_bytes": _nbytes(cell.args),
        "output_size_in_bytes": _nbytes(out),
        "temp_size_in_bytes": None,
        "temp_size_note": "not tracked: the peak of live local tensors "
                          "needs every storage's lifetime",
        "alias_size_in_bytes": None,
        "generated_code_size_in_bytes": None}
    return costs


def probe_config(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    changes: Dict[str, Any] = {"n_layers": n_layers, "scan_unroll": True}
    if cfg.is_encdec:
        changes["n_encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **changes)


def _cell_mesh(mesh_kind: str, variant: Dict[str, Any]) -> Mesh:
    if "mesh_shape" in variant:  # e.g. (32, 8): same 256 chips, TP=8
        d, m = variant["mesh_shape"]
        desc = Mesh(("data", "model"), (d, m))
    else:
        desc = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    return desc


def _with_devices(desc: Mesh, device: str) -> Mesh:
    """The described mesh with a device a rank, for the fake process
    group: the tensors' device type (meta tensors on a cpu mesh)."""
    return make_mesh(desc.sizes, desc.axis_names,
                     devices="cuda" if device == "cuda" else "cpu")


def measure_cell(arch: str, shape_name: str, mesh_kind: str,
                 with_probes: bool = True,
                 variant: Optional[Dict[str, Any]] = None,
                 device: str = "cuda",
                 hardware: TPUProfile = H100_SXM) -> Dict[str, Any]:
    """``variant`` overrides (seq_parallel / microbatch / fsdp / ep /
    moment_dtype / grad_compression / attn_impl / mesh_shape), the
    reference's A/B knobs; None = defaults.  ``hardware`` prices the
    roofline and the predicted terms (``roofline_tpu_v5e`` and
    ``distcalc_tpu_v5e`` are the reference's)."""
    t_cell = time.perf_counter()
    variant = variant or {}
    cfg = get_config(arch)
    if "attn_impl" in variant:
        cfg = dataclasses.replace(cfg, attn_impl=variant["attn_impl"])
    shape = SHAPES[shape_name]
    applies, reason = shape_applies(cfg, shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "time": time.time(), "device": device,
        "hardware": hardware.name}
    if not applies:
        record["skipped"] = reason
        return record

    mesh = _with_devices(_cell_mesh(mesh_kind, variant), device)
    record["mesh_shape"] = dict(mesh.shape)
    sp = variant.get("seq_parallel", shape.kind == "train")
    if shape.kind == "train":
        record["microbatch"] = variant.get(
            "microbatch", pick_microbatch(cfg, shape, mesh, sp))
        record["n_microbatches"] = shape.global_batch // record["microbatch"]
    record["seq_parallel"] = sp
    kw = dict(seq_parallel=sp,
              microbatch=record.get("microbatch"),
              fsdp=variant.get("fsdp", True),
              ep=variant.get("ep", True),
              moment_dtype=variant.get("moment_dtype", "float32"),
              grad_compression=variant.get("grad_compression", False),
              device=device)
    with fake_process_group(mesh.size):
        t0 = time.perf_counter()
        record["full"] = extract_costs(lower_cell(cfg, shape, mesh, **kw))
        record["compile_seconds"] = time.perf_counter() - t0

        if with_probes and mesh_kind == "single":
            p = PROBE_PERIOD[cfg.family]
            probes = {}
            for mult in (1, 2):
                pc = probe_config(cfg, p * mult)
                # probes run without gradient accumulation, as the
                # reference's (one pass has the same FLOPs)
                pkw = dict(kw, microbatch=shape.global_batch)
                probes[mult] = extract_costs(lower_cell(pc, shape, mesh,
                                                        **pkw))
            record["probes"] = {"period": p, "p1": probes[1],
                                "p2": probes[2]}
            record["extrapolated"] = extrapolate(cfg, probes[1], probes[2],
                                                 p)

    record["distcalc"] = predicted_terms(cfg, shape, mesh_kind, hardware)
    record["roofline"] = roofline_terms(cfg, shape, mesh_kind, record,
                                        hardware)
    record["distcalc_tpu_v5e"] = predicted_terms(cfg, shape, mesh_kind,
                                                 TPU_V5E)
    record["roofline_tpu_v5e"] = roofline_terms(cfg, shape, mesh_kind,
                                                record, TPU_V5E)
    record["seconds"] = time.perf_counter() - t_cell
    return record


def extrapolate(cfg: ArchConfig, p1: Dict, p2: Dict, period: int
                ) -> Dict[str, float]:
    """f(L) = a + b*L measured at L=period and 2*period."""
    L = cfg.n_layers
    out = {}
    for key, get in (("flops", lambda r: r["flops"]),
                     ("bytes_accessed", lambda r: r["bytes_accessed"]),
                     ("collective_bytes",
                      lambda r: r["collectives"]["moved_bytes_per_chip"])):
        f1, f2 = get(p1), get(p2)
        b = (f2 - f1) / period
        a = f1 - b * period
        out[key] = max(a + b * L, 0.0)
    return out


def predicted_terms(cfg: ArchConfig, shape: ShapeConfig | str,
                    mesh_kind: str, hardware: TPUProfile = H100_SXM
                    ) -> Dict[str, Any]:
    if isinstance(shape, str):
        shape = SHAPES[shape]
    mesh_spec = distcalc.MeshSpec(pods=2 if mesh_kind == "multi" else 1)
    strat, terms = distcalc.complete_strategy(cfg, shape, mesh_spec,
                                              tpu=hardware)
    return {"strategy": strat.describe(), **terms.to_json()}


def roofline_terms(cfg: ArchConfig, shape: ShapeConfig, mesh_kind: str,
                   record: Dict, hardware: TPUProfile = H100_SXM
                   ) -> Dict[str, Any]:
    """Three-term roofline on ``hardware`` from the counted (extrapolated
    where there are probes) per-chip costs."""
    chips = 512 if mesh_kind == "multi" else 256
    src = record.get("extrapolated") or {
        "flops": record["full"]["flops"],
        "bytes_accessed": record["full"]["bytes_accessed"],
        "collective_bytes":
            record["full"]["collectives"]["moved_bytes_per_chip"]}
    compute_s = src["flops"] / hardware.peak_flops_bf16
    memory_s = src["bytes_accessed"] / hardware.hbm_bw
    collective_s = src["collective_bytes"] / hardware.ici_bw
    mf = distcalc.model_flops(cfg, shape)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s,
             "dominant": max([("compute", compute_s), ("memory", memory_s),
                              ("collective", collective_s)],
                             key=lambda kv: kv[1])[0],
             "model_flops_total": mf,
             "model_flops_per_chip": mf / chips,
             "useful_flops_ratio":
                 (mf / chips) / src["flops"] if src["flops"] else 0.0,
             "roofline_fraction":
                 compute_s / max(compute_s, memory_s, collective_s)
                 if max(compute_s, memory_s, collective_s) > 0 else 0.0}
    return terms


# ---------------------------------------------------------------------------
# The sweep (a subprocess a cell: one fake process group a process)
# ---------------------------------------------------------------------------
def cell_path(arch: str, shape: str, mesh: str, tag: str = "",
              out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{suffix}.json")


def run_one(arch: str, shape: str, mesh: str, probes: bool,
            variant: Optional[Dict[str, Any]] = None,
            tag: str = "", device: str = "cuda",
            out_dir: str = OUT_DIR) -> Dict:
    record = measure_cell(arch, shape, mesh, with_probes=probes,
                          variant=variant, device=device)
    with open(cell_path(arch, shape, mesh, tag, out_dir), "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    return record


def sweep(mesh_kinds=("single", "multi"), force: bool = False,
          device: str = "cuda", out_dir: str = OUT_DIR) -> int:
    """Every (arch x shape x mesh) cell in a subprocess of its own; a
    cell already recorded is skipped unless ``force``.  Returns the
    number of cells that failed (each written as an ``error`` record)."""
    failed = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in mesh_kinds:
                path = cell_path(arch, shape, mesh, out_dir=out_dir)
                if os.path.exists(path) and not force:
                    print(f"skip (cached) {arch} {shape} {mesh}")
                    continue
                print(f"=== {arch} {shape} {mesh} ===", flush=True)
                proc = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--device", device, "--out-dir", out_dir],
                    env=dict(os.environ), capture_output=True, text=True,
                    timeout=7200)
                if proc.returncode != 0:
                    failed += 1
                    print(f"FAILED {arch} {shape} {mesh}:\n"
                          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}",
                          flush=True)
                    with open(path, "w") as fh:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh,
                                   "error": proc.stderr[-4000:]}, fh)
                else:
                    print(proc.stdout[-800:], flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="the device of the cell's fake tensors (meta: "
                         "meta tensors, no FakeTensorMode)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where the records go (one JSON file a cell)")
    # the reference's A/B knobs (written to a --tag'd variant file)
    ap.add_argument("--tag", default="", help="variant file suffix")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence parallelism")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate params across data (DP baseline)")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--moment-dtype", default=None,
                    choices=(None, "float32", "bfloat16"))
    ap.add_argument("--grad-compress", action="store_true",
                    help="bf16 gradient reduction")
    ap.add_argument("--no-ep", action="store_true",
                    help="replicate experts; TP inside the expert ffn")
    ap.add_argument("--attn-impl", default=None,
                    choices=("xla", "skip", "flash"),
                    help="'skip' = attention-internal-bytes ablation probe; "
                         "'flash' = kernel K5 (its fake op and flop "
                         "formula)")
    ap.add_argument("--mesh-shape", default=None,
                    help="single-pod mesh reshape, e.g. 32x8")
    args = ap.parse_args(argv)
    if args.all:
        return 1 if sweep(force=args.force, device=args.device,
                          out_dir=args.out_dir) else 0
    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape, or --all")
    variant: Dict[str, Any] = {}
    if args.no_sp:
        variant["seq_parallel"] = False
    if args.no_fsdp:
        variant["fsdp"] = False
    if args.microbatch is not None:
        variant["microbatch"] = args.microbatch
    if args.moment_dtype:
        variant["moment_dtype"] = args.moment_dtype
    if args.grad_compress:
        variant["grad_compression"] = True
    if args.no_ep:
        variant["ep"] = False
    if args.attn_impl:
        variant["attn_impl"] = args.attn_impl
    if args.mesh_shape:
        variant["mesh_shape"] = tuple(
            int(x) for x in args.mesh_shape.split("x"))
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    for mesh in meshes:
        record = run_one(args.arch, args.shape, mesh,
                         probes=not args.no_probes,
                         variant=variant or None, tag=args.tag,
                         device=args.device, out_dir=args.out_dir)
        summary = {k: record.get(k) for k in
                   ("arch", "shape", "mesh", "skipped", "compile_seconds",
                    "variant", "microbatch")}
        if "roofline" in record:
            summary["roofline"] = record["roofline"]
        if "full" in record:
            summary["memory"] = record["full"]["memory"]
            summary["collectives"] = record["full"]["collectives"][
                "per_kind_result_bytes"]
        print(json.dumps(summary, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
