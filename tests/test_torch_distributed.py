"""The port's sharded training step, remeshed restore and sharded decode
on a DeviceMesh of 8 ``gloo`` ranks (the twin of tests/test_distributed.py).

The reference forces 8 XLA host devices in a subprocess; the port runs one
subprocess that spawns 8 CPU processes, one thread each, joined by a
``gloo`` process group (a ``file://`` rendezvous under ``tmp_path``, so
parallel test workers cannot collide), and holds them against the
reference's single-device step computed here:

* qwen2-1.5b's smoke config in float32 compute, batch 8 x 32, from the
  reference's initial state (carried across by ``state_from_reference``),
  on a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh with sequence
  parallelism: loss and grad_norm within 1e-5 relative of the reference's
  jitted single-device step, the updated parameters within 1e-5 of each
  leaf's largest entry (as ``test_torch_train`` holds one device), at
  least one parameter sharded and collectives counted by
  ``CommDebugMode``; the same with ``attn_impl="flash"`` against the
  reference's flash step (its Pallas kernel in interpret mode);
* the state after step 1 saved from that mesh, restored onto ``(4, 2)``
  ``("data", "model")``: step 2's loss within 1e-5 relative of the
  ``(2, 2, 2)`` run's step 2;
* one decode step at batch 8 against a cache of 64 positions (random
  contents, a different position a row), the cache and parameters placed
  by the rules: logits and the updated cache within 1e-5 of the same step
  on one device, the cache written in place.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_get_smoke
from repro.configs.base import RunConfig as RRunConfig
from repro.models import build as r_build
from repro.train import loop as r_loop
from repro_torch import runtime
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.launch.mesh import (host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import build
from repro_torch.models.convert import (params_from_reference,
                                        state_from_reference)
from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import (batch_sharding, cache_shardings,
                                           param_shardings, placements)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = 1e-5

_SCRIPT = r"""
import dataclasses
import datetime
import json
import logging
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def worker(rank, work):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=600))
    try:
        run(rank, work)
    finally:
        dist.destroy_process_group()


def run(rank, work):
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import runtime
    from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import build
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import ctx
    from repro_torch.parallel.sharding import (batch_sharding,
                                               cache_shardings, full,
                                               param_shardings, place,
                                               state_shardings)
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.serve import make_serve_step

    runtime.set_device("cpu")
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              compute_dtype="float32")
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
    out = {}

    def batch_on(m, batch):
        return place(batch, {k: batch_sharding(m, 8, ndim=2)
                             for k in batch}, m)

    for impl in ("xla", "flash"):
        model = build(dataclasses.replace(cfg, attn_impl=impl))
        step = make_train_step(model, RunConfig())
        state = place(inputs["state"], state_shardings(inputs["state"],
                                                       mesh), mesh)
        comm = CommDebugMode()
        with ctx.mesh_context(mesh), ctx.options(seq_parallel=True), comm:
            state1, m = step(state, batch_on(mesh, inputs["batch1"]))
        m = full(m)
        out[impl] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "collectives": comm.get_total_counts(),
            "sharded_param_leaves": sum(
                1 for p in tree_leaves(state1.params)
                if any(pl.is_shard() for pl in p.placements)),
            "param_leaves": len(tree_leaves(state1.params))}
        params = full(state1.params)
        if rank == 0:
            torch.save(params, f"{work}/params_{impl}.pt")
        if impl == "xla":
            kept = (model, step, state1)

    # step 2 on the same mesh; then the state after step 1 saved from it
    # and restored onto (4, 2), directly and by train(), which takes step
    # 2 on the pipeline's batch for it (batch2)
    model, step, state1 = kept
    with ctx.mesh_context(mesh), ctx.options(seq_parallel=True):
        _, m = step(state1, batch_on(mesh, inputs["batch2"]))
    out["loss2_mesh_222"] = float(full(m)["loss"])
    save_checkpoint(f"{work}/ckpt", 1, state1)
    dist.barrier()
    remesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    template = init_state(model, 0, device="meta")
    at, restored = restore_checkpoint(
        f"{work}/ckpt", template,
        shardings=state_shardings(template, remesh), mesh=remesh)
    out["restored_step"] = at
    out["restored_opt_step"] = int(full(restored.opt.step))
    out["restored_sharded"] = sum(
        1 for p in tree_leaves(restored.params)
        if any(pl.is_shard() for pl in p.placements))
    run = RunConfig(total_steps=2, checkpoint_every=0,
                    checkpoint_dir=f"{work}/ckpt", log_every=1)
    trained = train(cfg, ShapeConfig("t", 32, 8, "train"), run,
                    mesh=remesh, log=lambda _msg: None)
    out["train_start"] = trained["start_step"]
    out["loss2_mesh_42"] = trained["losses"]
    dist.barrier()
    out["train_checkpoints"] = sorted(os.listdir(f"{work}/ckpt"))

    # one decode step, cache and parameters placed by the rules
    params = inputs["state"].params
    token, pos = inputs["token"], inputs["pos"]
    cache = {k: v.clone() for k, v in inputs["cache"].items()}
    want_logits, want_cache = model.decode_step(params, cache, token, pos)
    p_params = place(params, param_shardings(params, mesh), mesh)
    p_cache = place(inputs["cache"], cache_shardings(inputs["cache"], mesh,
                                                     8, cfg), mesh)
    rows = {k: batch_sharding(mesh, 8, ndim=1) for k in ("t", "p")}
    rows = place({"t": token, "p": pos}, rows, mesh)
    with ctx.mesh_context(mesh):
        logits, got_cache = make_serve_step(model)(p_params, p_cache,
                                                   rows["t"], rows["p"])
    out["decode_in_place"] = all(got_cache[k] is p_cache[k]
                                 for k in p_cache)
    out["decode_cache_placements"] = str(got_cache["k"].placements)
    out["decode_logits_max_abs"] = float(
        (full(logits) - want_logits).abs().max())
    out["decode_cache_max_abs"] = max(
        float((full(got_cache[k]) - want_cache[k]).abs().max())
        for k in want_cache)
    out["decode_logits_scale"] = float(want_logits.abs().max())
    out["decode_cache_scale"] = max(float(want_cache[k].abs().max())
                                    for k in want_cache)
    if rank == 0:
        with open(f"{work}/result.json", "w") as fh:
            json.dump(out, fh)


if __name__ == "__main__":
    sys.path.insert(0, sys.argv[2])
    mp.start_processes(worker, args=(sys.argv[1],), nprocs=WORLD,
                       start_method="spawn")
"""


def _cfgs(**kw):
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(r_get_smoke("qwen2-1.5b"), **kw),
            dataclasses.replace(get_smoke_config("qwen2-1.5b"), **kw))


def _batch(seed_tokens, seed_labels, vocab):
    return {"tokens": np.random.default_rng(seed_tokens).integers(
                0, vocab, (8, 32)).astype(np.int32),
            "labels": np.random.default_rng(seed_labels).integers(
                0, vocab, (8, 32)).astype(np.int32)}


def _close_leaves(got, want, what):
    """Every leaf within RTOL relative and RTOL of its largest entry."""
    def walk(g, w, path):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            return sum(walk(g[k], w[k], f"{path}/{k}") for k in w)
        if isinstance(w, (list, tuple)):
            assert len(g) == len(w), path
            return sum(walk(a, b, f"{path}/{i}")
                       for i, (a, b) in enumerate(zip(g, w)))
        w = w.float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=RTOL,
                                   atol=RTOL * scale,
                                   err_msg=f"{what} {path}")
        return 1

    return walk(got, want, "")


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    """The reference's single-device steps (plain and flash), then the
    8-rank run on the same state and batches; both results."""
    work = tmp_path_factory.mktemp("dist")
    cfg_r, cfg_p = _cfgs()
    state_r = r_loop.init_state(r_build(cfg_r), jax.random.PRNGKey(0))
    state_r = jax.tree.map(np.asarray, state_r)
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):     # non-zero biases, so they count
        b = state_r.params["layers"]["attn"][name]
        state_r.params["layers"]["attn"][name] = (
            0.1 * rng.standard_normal(b.shape)).astype(b.dtype)
    batch1 = _batch(0, 1, cfg_p.vocab_size)
    # step 2's batch: the pipeline's for step index 1, which train() takes
    batch2 = pipeline.make_batch(cfg_p, ShapeConfig("t", 32, 8, "train"),
                                 1, 0)
    ref = {}
    for impl in ("xla", "flash"):
        cfg = dataclasses.replace(cfg_r, attn_impl=impl)
        new_state, m = jax.jit(r_loop.make_train_step(
            r_build(cfg), RRunConfig()))(
            jax.tree.map(jnp.asarray, state_r),
            {k: jnp.asarray(v) for k, v in batch1.items()})
        ref[impl] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": params_from_reference(
                         jax.tree.map(np.asarray, new_state.params), cfg_p,
                         device="cpu")}
    hd = cfg_p.resolved_head_dim
    shape = (cfg_p.n_layers, 8, 64, cfg_p.n_kv_heads, hd)
    crng = np.random.default_rng(4)
    torch.save({
        "state": state_from_reference(state_r, cfg_p, device="cpu"),
        "batch1": {k: torch.as_tensor(v) for k, v in batch1.items()},
        "batch2": {k: torch.as_tensor(v) for k, v in batch2.items()},
        "cache": {k: torch.as_tensor(crng.standard_normal(shape).astype(
            np.float32)) for k in ("k", "v")},
        "token": torch.as_tensor(crng.integers(0, cfg_p.vocab_size, 8),
                                 dtype=torch.int32),
        "pos": torch.as_tensor([0, 5, 9, 17, 30, 42, 57, 63],
                               dtype=torch.int32)}, work / "inputs.pt")
    script = work / "spmd_port.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(work),
                           os.path.abspath(SRC)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-6000:]
    with open(work / "result.json") as fh:
        got = json.load(fh)
    for impl in ("xla", "flash"):
        got[impl]["params"] = torch.load(work / f"params_{impl}.pt")
    return ref, got


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_sharded_step_matches_the_reference_single_device(distributed,
                                                          impl):
    ref, got = distributed
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[impl][key], ref[impl][key],
                                   rtol=RTOL, err_msg=f"{impl} {key}")
    assert _close_leaves(got[impl]["params"], ref[impl]["params"],
                         f"{impl} params") == got[impl]["param_leaves"]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_sharded_step_shards_parameters_and_counts_collectives(distributed,
                                                               impl):
    _, got = distributed
    assert got[impl]["sharded_param_leaves"] > 0
    assert got[impl]["collectives"] > 0


def test_remeshed_restore_takes_the_same_next_step(distributed):
    """Saved from (2, 2, 2) after step 1, restored onto (4, 2) (sharded
    again by the new mesh's specs), and trained on by ``train()``, which
    resumes at step 1: step 2's loss is the (2, 2, 2) run's, and rank 0
    writes the final checkpoint."""
    _, got = distributed
    assert got["restored_step"] == 1 and got["restored_opt_step"] == 1
    assert got["restored_sharded"] > 0
    assert got["train_start"] == 1 and len(got["loss2_mesh_42"]) == 1
    np.testing.assert_allclose(got["loss2_mesh_42"][0],
                               got["loss2_mesh_222"], rtol=RTOL)
    assert got["train_checkpoints"] == ["hb", "step_00000001",
                                        "step_00000002"]


def test_sharded_decode_matches_one_device(distributed):
    _, got = distributed
    assert got["decode_in_place"]
    # [L, B, S, KH, hd]: batch over (pod, data), kv heads over model
    assert got["decode_cache_placements"] == \
        "(Shard(dim=1), Shard(dim=1), Shard(dim=3))"
    assert got["decode_logits_max_abs"] <= RTOL * max(
        1.0, got["decode_logits_scale"])
    assert got["decode_cache_max_abs"] <= RTOL * got["decode_cache_scale"]


def test_placements_follow_the_mesh_order():
    """A dim split over several axes is split in mesh order, and every
    spec the rules give (every parameter of the ten configs at full size,
    FSDP on and off, batch and cache specs) lists its axes in that order,
    so each maps onto DTensor placements; an entry out of order, or an
    axis named twice, is refused."""
    mesh = make_production_mesh(multi_pod=True)
    assert placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements((), mesh) == [Replicate()] * 3
    for bad in ((("data", "pod"), None), ("model", "model")):
        with pytest.raises(ValueError):
            placements(bad, mesh)
    n = 0
    with runtime.use_device("cpu"):
        for m in (mesh, make_production_mesh()):
            for arch in ARCH_IDS:
                model = build(get_config(arch))
                params = model.init(0, device="meta")
                for fsdp in (True, False):
                    specs = param_shardings(params, m, fsdp=fsdp)
                    for spec in _specs(specs):
                        placements(spec, m)
                        n += 1
                cache = model.init_cache(
                    32, 64, device="meta",
                    **({"src_len": 16} if model.cfg.family == "audio"
                       else {}))
                for spec in _specs(cache_shardings(cache, m, 32,
                                                   model.cfg)):
                    placements(spec, m)
            placements(batch_sharding(m, 32), m)
    assert n > 1000


def _specs(tree):
    """The specs of a tree of them: dicts, lists (layer stacks) and tuples
    of dicts (xLSTM blocks) hold them; a spec is a tuple of entries."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _specs(v)
    elif isinstance(tree, list) or (isinstance(tree, tuple) and
                                    any(isinstance(v, dict) for v in tree)):
        for v in tree:
            yield from _specs(v)
    else:
        yield tree


def test_mesh_of_several_devices_needs_its_process_group():
    """A description has no devices, and a mesh with devices needs an
    initialised process group of its size: both refuse to place."""
    with pytest.raises(ValueError, match="world size 256"):
        make_production_mesh().device_mesh()
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(RuntimeError, match="world size 4"):
        mesh.device_mesh()
    cuda = make_mesh((2,), ("data",), devices="cuda")
    assert cuda.devices == (torch.device("cuda", 0), torch.device("cuda", 1))


def test_constraints_return_their_input_on_the_host_mesh():
    """On the one-device host mesh every ``constrain_*`` returns its input
    itself, so a forward under the mesh is bit for bit the forward
    without one."""
    _, cfg = _cfgs()
    with runtime.use_device("cpu"):
        model = build(cfg)
        params = model.init(0, device="cpu")
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16)))
        plain, _ = model.forward(params, tokens)
        x = torch.ones((2, 16, cfg.d_model))
        with ctx.mesh_context(host_mesh()), ctx.options(seq_parallel=True):
            for fn in (ctx.constrain_bsd, ctx.constrain_residual,
                       ctx.constrain_ffn, ctx.constrain_logits):
                assert fn(x) is x
            h = torch.ones((2, 16, cfg.n_heads, 16))
            assert ctx.constrain_heads(h) is h
            e = torch.ones((4, 3, cfg.d_model))
            assert ctx.constrain_experts(e) is e
            meshed, _ = model.forward(params, tokens)
    assert torch.equal(meshed, plain)
