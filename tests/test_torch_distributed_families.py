"""Every model family's train step, decode step and prefill on a
DeviceMesh of 8 ``gloo`` ranks, held against the reference's
single-device steps (the families' twin of
``tests/test_torch_distributed.py``, which holds the dense family).

One subprocess spawns 8 CPU processes, one thread each, joined by a
``gloo`` process group (a ``file://`` rendezvous under ``tmp_path``) on a
``(2, 2, 2)`` ``("pod", "data", "model")`` mesh.  Each case starts from
the reference's initial state (carried across by
``state_from_reference``), placed by the sharding rules, and the
reference's batch, placed by the batch rules; the train step runs with
sequence parallelism, as the dry run lowers a train cell:

* the loss, aux loss and grad_norm within 1e-5 relative of the
  reference's jitted single-device step, the updated parameters and
  moments within 1e-5 of each leaf's largest entry, as
  ``tests/test_torch_train.py`` holds one device (the scan families,
  zamba2 and xlstm, within that file's ``SCAN_CASES`` limits, which say
  why);
* one decode step at batch 8 against a cache of random contents (a
  different position a row), the cache and parameters placed by the
  rules: the logits and every cache leaf within 1e-5 of the largest
  entry of the reference's single-device decode step;
* the fused prefill (granite's MoE, pixtral's patches as ``embeds=``)
  through ``train.serve.make_prefill_step``: the last position's logits
  and the KV cache within 1e-5 of the reference's prefill.

MoE runs with expert parallelism on (experts split over "model") and
off (the experts' hidden dim split instead).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_get_smoke
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.data import pipeline as r_pipeline
from repro.models import build as r_build
from repro.optim import adamw as r_adamw
from repro.train import loop as r_loop
from repro.train import serve as r_serve
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import (params_from_reference,
                                        state_from_reference)
from repro_torch.optim.adamw import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = 1e-5
BATCH, SEQ, CACHE_LEN, SRC_LEN = 8, 32, 64, 16

#: case -> (arch, expert parallelism, has a fused prefill)
CASES = {
    "moe_ep": ("granite-moe-1b-a400m", True, True),
    "moe_no_ep": ("granite-moe-1b-a400m", False, False),
    "hybrid": ("zamba2-1.2b", True, False),
    "ssm": ("xlstm-350m", True, False),
    "audio": ("seamless-m4t-large-v2", True, False),
    "vlm": ("pixtral-12b", True, True),
}
#: the scan families (tests/test_torch_train.py's SCAN_CASES)
SCAN_CASES = ("hybrid", "ssm")

_SCRIPT = r"""
import datetime
import json
import logging
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
                            timeout=datetime.timedelta(seconds=900))
    try:
        run(rank, work)
    finally:
        dist.destroy_process_group()


def run(rank, work):
    import time
    from repro_torch import runtime
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    from repro_torch.parallel import ctx
    from repro_torch.parallel.sharding import (batch_sharding,
                                               cache_shardings,
                                               embeds_sharding, full,
                                               param_shardings, place,
                                               state_shardings)
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.serve import make_prefill_step, make_serve_step

    runtime.set_device("cpu")
    cases = torch.load(f"{work}/inputs.pt", weights_only=False)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
    seconds = {}
    for name, case in cases.items():
        cfg, ep = case["cfg"], case["ep"]
        model = build(cfg)
        t0 = time.perf_counter()
        batch = case["batch"]
        specs = {k: embeds_sharding(mesh, v.shape[0]) if k == "embeds"
                 else batch_sharding(mesh, v.shape[0], ndim=v.dim())
                 for k, v in batch.items()}
        state = place(case["state"], state_shardings(case["state"], mesh,
                                                     ep=ep), mesh)
        with ctx.mesh_context(mesh), ctx.options(seq_parallel=True,
                                                 expert_parallel=ep):
            state1, m = make_train_step(model, RunConfig())(
                state, place(batch, specs, mesh))
        out = {"metrics": {k: float(v) for k, v in full(m).items()},
               "params": full(state1.params), "mu": full(state1.opt.mu),
               "nu": full(state1.opt.nu)}
        seconds[f"{name} train"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        params = place(case["state"].params,
                       param_shardings(case["state"].params, mesh, ep=ep),
                       mesh)
        cache = place(case["cache"], cache_shardings(case["cache"], mesh,
                                                     case["token"].shape[0],
                                                     cfg), mesh)
        rows = place({"t": case["token"], "p": case["pos"]},
                     {k: batch_sharding(mesh, case["token"].shape[0],
                                        ndim=1) for k in ("t", "p")}, mesh)
        with ctx.mesh_context(mesh), ctx.options(expert_parallel=ep):
            logits, got_cache = make_serve_step(model)(params, cache,
                                                       rows["t"], rows["p"])
        out["decode_logits"] = full(logits)
        out["decode_cache"] = full(got_cache)
        seconds[f"{name} decode"] = time.perf_counter() - t0

        if case["prefill"] is not None:
            t0 = time.perf_counter()
            pre = case["prefill"]
            args = {"tokens": pre["tokens"]}
            specs = {"tokens": batch_sharding(mesh, BATCH_)}
            if "embeds" in pre:
                args["embeds"] = pre["embeds"]
                specs["embeds"] = embeds_sharding(mesh, BATCH_)
            args = place(args, specs, mesh)
            with ctx.mesh_context(mesh), ctx.options(expert_parallel=ep):
                logits, kv = make_prefill_step(model, pre["max_len"])(
                    params, args["tokens"], embeds=args.get("embeds"))
            out["prefill_logits"] = full(logits)
            out["prefill_cache"] = full(kv)
            seconds[f"{name} prefill"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(out, f"{work}/out_{name}.pt")
    if rank == 0:
        with open(f"{work}/seconds.json", "w") as fh:
            json.dump(seconds, fh)


if __name__ == "__main__":
    sys.path.insert(0, sys.argv[2])
    mp.start_processes(worker, args=(sys.argv[1],), nprocs=WORLD,
                       start_method="spawn")
""".replace("BATCH_", str(BATCH))


def _cfgs(arch):
    kw = dict(compute_dtype="float32")
    return (dataclasses.replace(r_get_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.as_tensor(np.asarray(tree))


def _random_like(tree, rng):
    """A tree of the same structure, float leaves standard normal."""
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) if np.issubdtype(a.dtype, np.floating) else
        np.zeros(a.shape, a.dtype), tree)


def _reference_case(name):
    """The reference's single-device train step, decode step and (where
    the family has one) prefill, and the port's inputs for them."""
    arch, ep, has_prefill = CASES[name]
    cfg_r, cfg_p = _cfgs(arch)
    model_r = r_build(cfg_r)
    state_r = _np_tree(r_loop.init_state(model_r, jax.random.PRNGKey(0)))
    batch = r_pipeline.make_batch(cfg_r, RShapeConfig("t", SEQ, BATCH,
                                                      "train"), 0, 0)
    new_state, metrics = jax.jit(r_loop.make_train_step(
        model_r, RRunConfig()))(jax.tree.map(jnp.asarray, state_r),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.default_rng(4)
    kw = {"src_len": SRC_LEN} if cfg_r.family == "audio" else {}
    cache = _random_like(jax.eval_shape(
        lambda: model_r.init_cache(BATCH, CACHE_LEN, **kw)), rng)
    token = rng.integers(0, cfg_r.vocab_size, BATCH).astype(np.int32)
    pos = np.array([0, 5, 9, 17, 30, 42, 57, 63], np.int32)
    params_j = jax.tree.map(jnp.asarray, state_r.params)
    logits, new_cache = jax.jit(r_serve.make_serve_step(model_r))(
        params_j, jax.tree.map(jnp.asarray, cache), jnp.asarray(token),
        jnp.asarray(pos))
    want = {"state": new_state, "metrics": {k: float(v)
                                            for k, v in metrics.items()},
            "decode_logits": np.asarray(logits),
            "decode_cache": _np_tree(new_cache)}
    inputs = {"cfg": cfg_p, "ep": ep,
              "state": state_from_reference(state_r, cfg_p, device="cpu"),
              "batch": {k: torch.as_tensor(v) for k, v in batch.items()},
              "cache": _torch_tree(cache), "token": torch.as_tensor(token),
              "pos": torch.as_tensor(pos), "prefill": None}
    if has_prefill:
        n_text = SEQ - cfg_r.n_patches
        tokens = rng.integers(0, cfg_r.vocab_size,
                              (BATCH, n_text)).astype(np.int32)
        pre = {"tokens": tokens, "max_len": CACHE_LEN}
        args = [jnp.asarray(tokens)]
        if cfg_r.n_patches:
            pre["embeds"] = rng.standard_normal(
                (BATCH, cfg_r.n_patches, cfg_r.d_model)).astype(np.float32)
            args.append(jnp.asarray(pre["embeds"]))
        logits, kv = jax.jit(r_serve.make_prefill_step(
            model_r, CACHE_LEN))(params_j, *args)
        want["prefill_logits"] = np.asarray(logits)
        want["prefill_cache"] = _np_tree(kv)
        inputs["prefill"] = {k: torch.as_tensor(v) if isinstance(
            v, np.ndarray) else v for k, v in pre.items()}
    return want, inputs


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    work = tmp_path_factory.mktemp("families")
    wants, inputs = {}, {}
    for name in CASES:
        wants[name], inputs[name] = _reference_case(name)
    torch.save(inputs, work / "inputs.pt")
    script = work / "families_port.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(work),
                           os.path.abspath(SRC)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-6000:]
    got = {name: torch.load(work / f"out_{name}.pt") for name in CASES}
    with open(work / "seconds.json") as fh:
        seconds = json.load(fh)
    return wants, got, inputs, seconds


def _close(got, want, what, atol_scale=RTOL, atol=0.0):
    """Every leaf within RTOL relative and ``atol_scale`` of its largest
    entry (or ``atol`` where that is larger); the number of leaves."""
    def walk(g, w, path):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            return sum(walk(g[k], w[k], f"{path}/{k}") for k in w)
        if isinstance(w, (list, tuple)):
            assert len(g) == len(w), path
            return sum(walk(a, b, f"{path}/{i}")
                       for i, (a, b) in enumerate(zip(g, w)))
        w = np.asarray(w, np.float32) if not isinstance(w, torch.Tensor) \
            else w.float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=RTOL,
                                   atol=max(atol_scale * scale, atol),
                                   err_msg=f"{what} {path}")
        return 1

    return walk(got, want, "")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_matches_the_reference(families, name):
    wants, got, inputs, _ = families
    want, out = wants[name], got[name]
    cfg = inputs[name]["cfg"]
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(out["metrics"][key], want["metrics"][key],
                                   rtol=RTOL, atol=1e-7,
                                   err_msg=f"{name} {key}")
    scan = name in SCAN_CASES
    run = RRunConfig()
    gnorm = want["metrics"]["grad_norm"]
    state = want["state"]
    n = len(tree_leaves(out["params"]))
    assert _close(out["mu"], params_from_reference(
        _np_tree(state.opt.mu), cfg, device="cpu"), f"{name} mu",
        atol=RTOL * (1 - run.b1) * gnorm if scan else 0.0) == n
    assert _close(out["nu"], params_from_reference(
        _np_tree(state.opt.nu), cfg, device="cpu"), f"{name} nu",
        atol=2 * RTOL * (1 - run.b2) * gnorm ** 2 if scan else 0.0) == n
    lr1 = float(r_adamw.cosine_schedule(jnp.int32(1), run)) if scan else 0
    assert _close(out["params"], params_from_reference(
        _np_tree(state.params), cfg, device="cpu"), f"{name} params",
        atol=0.05 * lr1) == n


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_step_matches_the_reference(families, name):
    wants, got, _, _ = families
    want, out = wants[name], got[name]
    _close(out["decode_logits"], want["decode_logits"], f"{name} logits")
    assert _close(out["decode_cache"], want["decode_cache"],
                  f"{name} cache") == len(tree_leaves(out["decode_cache"]))


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][2]])
def test_sharded_prefill_matches_the_reference(families, name):
    wants, got, _, _ = families
    want, out = wants[name], got[name]
    _close(out["prefill_logits"], want["prefill_logits"],
           f"{name} prefill logits")
    assert _close(out["prefill_cache"], want["prefill_cache"],
                  f"{name} prefill cache") == 2
