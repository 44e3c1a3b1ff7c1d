"""Port vs reference: the training path on the CPU.

The same state (the reference's ``init_state`` carried across by
``state_from_reference``, with non-zero QKV biases so they count) and the
same numpy-seeded batches go through both packages' ``train_step``, in
float32 compute: loss and grad_norm within 1e-5 relative, the updated
parameters and moments within 1e-5 relative of their largest entry.  The
reference's flash path runs its Pallas kernel in interpret mode; the
port's, kernel K5's plain version on CPU tensors.  Batches must be bit for
bit the reference's; chunked CE within 1e-5.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.checkpoint import checkpoint as r_ckpt
from repro.configs import get_smoke_config as r_get_smoke
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.data import pipeline as r_pipeline
from repro.launch import train as r_launch
from repro.models import build as r_build
from repro.optim import adamw as r_adamw
from repro.train import loop as r_loop
from repro_torch import runtime
from repro_torch.checkpoint.checkpoint import save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as p_launch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build
from repro_torch.models.convert import (params_from_reference,
                                        state_from_reference)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loop

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _cfgs(arch="qwen2-1.5b", **kw):
    """(reference cfg, port cfg): the smoke config in float32 compute."""
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(r_get_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _states(cfg_r, cfg_p, seed=0):
    """The reference's initial state (QKV biases made non-zero) as numpy,
    and the same state in the port."""
    state = r_loop.init_state(r_build(cfg_r), jax.random.PRNGKey(seed))
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed)
    layers = state.params.get("layers")
    if isinstance(layers, dict) and "bq" in layers.get("attn", {}):
        for name in ("bq", "bk", "bv"):
            b = layers["attn"][name]
            layers["attn"][name] = (0.1 * rng.standard_normal(b.shape)
                                    ).astype(b.dtype)
    return state, state_from_reference(state, cfg_p, device="cpu")


def _batches(cfg_r, b, s, step=0, seed=0):
    shape = RShapeConfig("t", s, b, "train")
    batch = r_pipeline.make_batch(cfg_r, shape, step, seed)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _close_trees(got, want, cfg, what, rtol=RTOL, atol=0.0):
    """Every leaf of the port's tree within ``rtol`` (and RTOL of the
    largest entry, or ``atol`` where that is larger) of the reference's,
    unstacked into the port's layout, at the same key."""
    want = params_from_reference(jax.tree.map(np.asarray, want), cfg,
                                 device="cpu")

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
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=max(RTOL * scale, atol),
                                   err_msg=f"{what} {path}")
        return 1

    assert walk(got, want, "") == len(tree_leaves(got))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "seamless-m4t-large-v2",
                                  "pixtral-12b"])
@pytest.mark.parametrize("step,seed", [(0, 0), (3, 7)])
def test_make_batch_bit_equal_to_reference(arch, step, seed):
    """Dense, audio (source frames) and VLM (patches) batches."""
    shape = ShapeConfig("t", 48, 4, "train")
    got = pipeline.make_batch(get_smoke_config(arch), shape, step, seed)
    want = r_pipeline.make_batch(r_get_smoke(arch),
                                 RShapeConfig("t", 48, 4, "train"), step,
                                 seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_shards_bit_equal_to_reference():
    for shard in (0, 1, 2):
        got = pipeline.synthetic_batch(5, 12, 16, 1000, seed=3, shard=shard,
                                       n_shards=3)
        want = r_pipeline.synthetic_batch(5, 12, 16, 1000, seed=3,
                                          shard=shard, n_shards=3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 512), (60, 16)])
def test_chunked_cross_entropy_matches_reference(s, chunk, monkeypatch):
    """Slices of 16, one slice, and the naive fallback (60 % 16 != 0)."""
    cfg_r, cfg_p = _cfgs()
    state_r, state_p = _states(cfg_r, cfg_p)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg_p.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg_p.vocab_size, (2, s)).astype(np.int32)
    monkeypatch.setattr(loop, "CE_CHUNK", chunk)
    monkeypatch.setattr(r_loop, "CE_CHUNK", chunk)
    got = loop.chunked_cross_entropy(torch.as_tensor(x),
                                     state_p.params["embed"],
                                     torch.as_tensor(labels), cfg_p)
    want = r_loop.chunked_cross_entropy(
        jnp.asarray(x), jax.tree.map(jnp.asarray, state_r.params["embed"]),
        jnp.asarray(labels), cfg_r)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


# ---------------------------------------------------------------------------
# one train step from the same state
# ---------------------------------------------------------------------------
STEP_CASES = {
    "plain": ("qwen2-1.5b", dict(), dict()),
    "flash": ("qwen2-1.5b", dict(attn_impl="flash"), dict()),
    "microbatch": ("qwen2-1.5b", dict(), dict(microbatch=2)),
    "grad_compression": ("qwen2-1.5b", dict(),
                         dict(grad_compression=True)),
    "remat": ("qwen2-1.5b", dict(remat=True), dict()),
    "remat_flash": ("qwen2-1.5b", dict(remat=True, attn_impl="flash"),
                    dict()),
    "moe_aux_loss": ("granite-moe-1b-a400m", dict(), dict()),
    "vlm_text_slice": ("pixtral-12b", dict(), dict()),
    "hybrid": ("zamba2-1.2b", dict(), dict()),
    "ssm": ("xlstm-350m", dict(), dict()),
    "audio": ("seamless-m4t-large-v2", dict(), dict()),
}

#: the scan families' gradients sum long products over every token (the
#: Mamba2 ``dt_bias``, the sLSTM's recurrence), so a leaf whose entries
#: cancel to near zero carries float-order noise that is large against
#: its own largest entry but not against the gradient as a whole: their
#: moments are held to RTOL of the global gradient norm (mu = (1-b1) g,
#: nu = (1-b2) g^2, whose gap is at most 2 (1-b2) |g| |dg|), and their
#: parameters to 5% of step 1's learning rate, since AdamW's first update
#: lr g / (|g| + 1e-8) turns a float-order gap in a gradient near its
#: 1e-8 epsilon into a gap of a fraction of lr (the sign, and every
#: update of a gradient well above epsilon, stay held)
SCAN_CASES = ("hybrid", "ssm")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(case):
    arch, cfg_kw, run_kw = STEP_CASES[case]
    cfg_r, cfg_p = _cfgs(arch, **cfg_kw)
    state_r, state_p = _states(cfg_r, cfg_p)
    batch_r, batch_p = _batches(cfg_r, 4, 32)
    run_r, run_p = RRunConfig(**run_kw), RunConfig(**run_kw)
    want_state, want = jax.jit(r_loop.make_train_step(
        r_build(cfg_r), run_r))(jax.tree.map(jnp.asarray, state_r), batch_r)
    got_state, got = loop.make_train_step(build(cfg_p), run_p)(state_p,
                                                               batch_p)
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL, atol=1e-7, err_msg=key)
    assert int(got_state.opt.step) == int(want_state.opt.step) == 1
    # under grad_compression a gradient is rounded to bf16 twice (the
    # compression, then the clipped gradient, kept in its dtype), and each
    # rounding may land one bf16 ulp (at most 2^-7 of the value) apart in
    # the two packages where the float32 values straddle a boundary; the
    # moments carry that (nu, the square, twice the relative distance)
    rtol = 2.0 ** -6 if run_p.grad_compression else RTOL
    gnorm = float(want["grad_norm"])
    scan = case in SCAN_CASES
    _close_trees(got_state.opt.mu, want_state.opt.mu, cfg_p, f"{case} mu",
                 rtol, atol=RTOL * (1 - run_p.b1) * gnorm if scan else 0.0)
    _close_trees(got_state.opt.nu, want_state.opt.nu, cfg_p, f"{case} nu",
                 2 * rtol if run_p.grad_compression else RTOL,
                 atol=2 * RTOL * (1 - run_p.b2) * gnorm ** 2 if scan
                 else 0.0)
    lr1 = float(r_adamw.cosine_schedule(jnp.int32(1), run_r)) if scan else 0
    _close_trees(got_state.params, want_state.params, cfg_p,
                 f"{case} params", atol=0.05 * lr1)


# ---------------------------------------------------------------------------
# remat: the same gradients, and K5 run again in the backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "zamba2-1.2b", "xlstm-350m",
                                  "seamless-m4t-large-v2", "pixtral-12b"])
def test_remat_gives_the_gradients_without_it(arch):
    """Every family's rematerialized layers give the gradients the plain
    forward does (float32, within 1e-6 of each leaf's largest entry:
    autograd may add a shared weight's contributions in another order)."""
    out = {}
    for remat in (False, True):
        _, cfg = _cfgs(arch, remat=remat)
        model = build(cfg)
        params = model.init(0, device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in pipeline.make_batch(
            cfg, ShapeConfig("t", 32, 2, "train"), 0, 0).items()}
        out[remat] = loop.loss_and_grads(params, batch, model)
    (m0, g0), (m1, g1) = out[False], out[True]
    assert float(m0["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        scale = max(float(a.abs().max()), 1e-30)
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_runs_flash_attention_twice_a_layer(remat, monkeypatch):
    """Under remat the backward recomputes each layer's forward, so K5's
    forward (here its plain version, on CPU tensors) runs 2 times a layer
    a step, as in the reference; without it, once."""
    calls = []
    real = fa_ops._forward
    monkeypatch.setattr(fa_ops, "_forward",
                        lambda *a: calls.append(1) or real(*a))
    _, cfg = _cfgs(remat=remat, attn_impl="flash")
    model = build(cfg)
    state = loop.init_state(model, 0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in pipeline.make_batch(
        cfg, ShapeConfig("t", 32, 2, "train"), 0, 0).items()}
    loop.train_step(state, batch, model, RunConfig())
    assert len(calls) == (2 if remat else 1) * cfg.n_layers
    calls.clear()
    with torch.no_grad():                # serving: no recompute
        model.forward(state.params, batch["tokens"])
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------------------
# checkpoints and train() across packages
# ---------------------------------------------------------------------------
def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A state saved by the reference's save_checkpoint, restored by the
    reference and carried across, steps to the reference's next loss."""
    cfg_r, cfg_p = _cfgs()
    state_r, _ = _states(cfg_r, cfg_p)
    model_r = r_build(cfg_r)
    step_r = jax.jit(r_loop.make_train_step(model_r, RRunConfig()))
    batch_r, batch_p = _batches(cfg_r, 2, 32, step=1)
    state_r, _ = step_r(jax.tree.map(jnp.asarray, state_r), batch_r)
    r_ckpt.save_checkpoint(str(tmp_path), 1, state_r)
    template = jax.eval_shape(
        lambda: r_loop.init_state(model_r, jax.random.PRNGKey(0)))
    _, restored = r_ckpt.restore_checkpoint(str(tmp_path), template)
    carried = state_from_reference(jax.tree.map(np.asarray, restored),
                                   cfg_p, device="cpu")
    assert int(carried.opt.step) == 1
    _, want = step_r(restored, batch_r)
    _, got = loop.train_step(carried, batch_p, build(cfg_p), RunConfig())
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=RTOL)


def test_train_matches_reference_for_three_steps(tmp_path):
    """Both packages' ``train()`` from one initial state (each restores
    it from its own checkpoint at step 0), 3 steps: the same per-step
    losses (full precision for the first and last, which the reference
    returns; the reference's 4-decimal log for the middle one).  The
    reference runs on a mesh of Auto axes: on its default host mesh this
    JAX refuses its embedding gather (ROADMAP Queue 3)."""
    cfg_r, cfg_p = _cfgs()
    state_r, state_p = _states(cfg_r, cfg_p)
    dirs = {p: str(tmp_path / p) for p in ("ref", "port")}
    r_ckpt.save_checkpoint(dirs["ref"], 0, state_r)
    save_checkpoint(dirs["port"], 0, state_p)
    kw = dict(total_steps=3, warmup_steps=1, checkpoint_every=0,
              log_every=1)
    shape = (32, 2)
    logged = []
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    want = r_launch.train(cfg_r, RShapeConfig("t", *shape, "train"),
                          RRunConfig(checkpoint_dir=dirs["ref"], **kw),
                          mesh=mesh, log=logged.append)
    got = p_launch.train(cfg_p, ShapeConfig("t", *shape, "train"),
                         RunConfig(checkpoint_dir=dirs["port"], **kw),
                         log=lambda _: None)
    assert got["steps"] == want["steps"] == 3 and got["start_step"] == 0
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=RTOL)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=RTOL)
    middle = [float(line.split("loss")[1].split()[0]) for line in logged
              if line.startswith("step")][1]
    assert abs(got["losses"][1] - middle) <= 5e-5 + RTOL * abs(middle)
    assert got["health"] == {"dead": [], "stragglers": []}


def test_resumed_train_takes_the_uninterrupted_losses(tmp_path):
    """A checkpoint step_<n> holds the state after n steps: resumed from
    step 2 of 4, the port's train() gives the uninterrupted run's losses
    for steps 2 and 3 bit for bit.  (The reference labels its periodic
    checkpoints one step early and replays a batch: ROADMAP Queue 3.)"""
    _, cfg = _cfgs()
    run = RunConfig(total_steps=4, warmup_steps=1, checkpoint_every=2,
                    checkpoint_dir=str(tmp_path), log_every=1)
    shape = ShapeConfig("t", 32, 2, "train")
    full = p_launch.train(cfg, shape, run, log=lambda _: None)
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_00000002", "step_00000004"]
    with np.load(tmp_path / "step_00000002" / "arrays.npz") as data:
        assert int(data[".opt/.step"]) == 2
    shutil.rmtree(tmp_path / "step_00000004")
    resumed = p_launch.train(cfg, shape, run, log=lambda _: None)
    assert resumed["start_step"] == 2
    assert resumed["losses"] == full["losses"][2:]


def test_train_refuses_a_mesh_of_several_devices(tmp_path):
    """The production mesh is a description (256 chips this host does not
    have): train() refuses it, naming the world size it needs."""
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="world size 256"):
        p_launch.train(cfg, ShapeConfig("t", 16, 2, "train"),
                       RunConfig(total_steps=1,
                                 checkpoint_dir=str(tmp_path)),
                       mesh=make_production_mesh())


def test_train_needs_the_card_unless_asked_for_the_cpu(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runtime, "_CHOSEN", None)
    _, cfg = _cfgs()
    with pytest.raises(runtime.NoDeviceError):
        p_launch.train(cfg, ShapeConfig("t", 16, 2, "train"),
                       RunConfig(total_steps=1, checkpoint_dir=str(tmp_path)))


def test_cli_trains_the_smoke_config_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16",
        "--checkpoint-dir", str(tmp_path)])
    monkeypatch.setattr(runtime, "_CHOSEN", None)    # --device cpu alone
    p_launch.main()
    out = capsys.readouterr().out
    assert "'steps': 2" in out and "step_00000002" in os.listdir(tmp_path)
