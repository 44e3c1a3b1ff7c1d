"""The port's training infrastructure on the CPU, the twins of
tests/test_train_infra.py: optimizer, gradient accumulation, chunked CE,
checkpointing, data pipeline, fault tolerance, gradient compression and
bf16 moments.  (The distcalc tests wait for the port of core/distcalc.)"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.checkpoint.checkpoint import (CheckpointManager, latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig, SHAPES
from repro_torch.data.pipeline import (DataPipeline, make_batch,
                                       synthetic_batch)
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.optim.adamw import (adamw_init, adamw_update, apply_updates,
                                     clip_by_global_norm, cosine_schedule,
                                     tree_leaves)
from repro_torch.train import ft
from repro_torch.train import loop
from repro_torch.train.loop import (chunked_cross_entropy, cross_entropy_loss,
                                    init_state, make_train_step)


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                               dtype=torch.int32)
            for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_adamw_minimizes_quadratic():
    run = RunConfig(learning_rate=0.1, warmup_steps=1, total_steps=200,
                    weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        updates, state = adamw_update(grads, state, params, run)
        params = apply_updates(params, updates)
    assert float(params["w"].abs().max()) < 0.5


def test_clip_by_global_norm():
    grads = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    got = float(torch.sqrt((clipped["a"] ** 2).sum()))
    assert got == pytest.approx(1.0, rel=1e-4)


def test_cosine_schedule_warmup_and_decay():
    run = RunConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lr0 = float(cosine_schedule(torch.tensor(1), run))
    lr_peak = float(cosine_schedule(torch.tensor(10), run))
    lr_end = float(cosine_schedule(torch.tensor(100), run))
    assert lr0 < lr_peak
    assert lr_end < lr_peak
    assert lr_end >= 0.09 * run.learning_rate  # 10% floor


# ---------------------------------------------------------------------------
# chunked CE + gradient accumulation equivalences
# ---------------------------------------------------------------------------
def test_chunked_ce_matches_naive(monkeypatch):
    cfg = get_smoke_config("qwen2-1.5b")
    model = build(cfg)
    params = model.init(0)
    batch = _batch(cfg, 2, 64)
    x, _ = model.forward(params, batch["tokens"], hidden=True)
    naive = cross_entropy_loss(L.unembed(params["embed"], x, cfg),
                               batch["labels"])
    monkeypatch.setattr(loop, "CE_CHUNK", 16)
    chunked = chunked_cross_entropy(x, params["embed"], batch["labels"], cfg)
    np.testing.assert_allclose(float(chunked), float(naive), rtol=1e-5)


def test_grad_accumulation_matches_full_batch():
    cfg = get_smoke_config("qwen2-1.5b")
    model = build(cfg)
    state = init_state(model, 0)
    batch = _batch(cfg, 8, 32)
    s1, m1 = make_train_step(model, RunConfig())(state, batch)
    s2, m2 = make_train_step(model, RunConfig(microbatch=2))(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-3)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-5)


def test_train_step_leaves_its_input_state_alone():
    """Functional, as the reference: one state can be stepped twice."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = build(cfg)
    state = init_state(model, 0)
    before = [t.clone() for t in tree_leaves(state)]
    step = make_train_step(model, RunConfig())
    _, m1 = step(state, _batch(cfg, 2, 16))
    _, m2 = step(state, _batch(cfg, 2, 16))
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(before, tree_leaves(state)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(8.0),
            "b": {"c": torch.randn(3, 3).to(torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 7, tree, extra={"loss": 1.5})
    assert latest_step(str(tmp_path)) == 7
    step, restored = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(8.0))
    assert restored["b"]["c"].dtype == torch.bfloat16
    # bf16 comes back bit for bit (stored as its 16-bit pattern)
    assert torch.equal(restored["b"]["c"].view(torch.int16),
                       tree["b"]["c"].view(torch.int16))


def test_checkpoint_atomicity(tmp_path):
    """A .tmp directory must never be visible as a checkpoint."""
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 4, {"x": torch.zeros(2)})
    assert latest_step(str(tmp_path)) == 4


def test_checkpoint_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.full((4,), float(step))})
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    _, restored = restore_checkpoint(str(tmp_path), {"x": torch.zeros(4)})
    assert float(restored["x"][0]) == 4.0


def test_checkpoint_manager_snapshots_before_returning(tmp_path):
    """The host copy is taken on the caller's thread: changing the tensor
    after ``save`` returns does not reach the checkpoint."""
    x = torch.ones(4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x})
    x.fill_(7.0)
    mgr.wait()
    _, restored = restore_checkpoint(str(tmp_path), {"x": torch.zeros(4)})
    assert torch.equal(restored["x"], torch.ones(4))


def test_restore_rejects_a_template_of_another_shape(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(5)})


def test_restart_resumes_training(tmp_path):
    """Kill-and-restart: restore reproduces the exact state."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = build(cfg)
    state = init_state(model, 0)
    step_fn = make_train_step(model, RunConfig())
    batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    state, _ = step_fn(state, batch)
    save_checkpoint(str(tmp_path), 1, state)
    # "crash"; restart from disk, the template on the meta device
    template = init_state(model, 0, device="meta")
    step, restored = restore_checkpoint(str(tmp_path), template,
                                        device="cpu")
    assert step == 1
    state2, m2 = step_fn(restored, batch)
    state1, m1 = step_fn(state, batch)
    assert float(m1["loss"]) == float(m2["loss"])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
def test_synthetic_batch_deterministic_and_sharded():
    full = synthetic_batch(step=3, batch=8, seq_len=16, vocab=100)
    again = synthetic_batch(step=3, batch=8, seq_len=16, vocab=100)
    np.testing.assert_array_equal(full["tokens"], again["tokens"])
    other_step = synthetic_batch(step=4, batch=8, seq_len=16, vocab=100)
    assert not np.array_equal(full["tokens"], other_step["tokens"])
    s0 = synthetic_batch(step=3, batch=8, seq_len=16, vocab=100,
                         shard=0, n_shards=2)
    s1 = synthetic_batch(step=3, batch=8, seq_len=16, vocab=100,
                         shard=1, n_shards=2)
    assert s0["tokens"].shape == (4, 16)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert (full["tokens"] < 100).all()


def test_pipeline_prefetch_and_restart_safety():
    cfg = get_smoke_config("qwen2-1.5b")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2,
                                seq_len=16)
    pipe = DataPipeline(cfg, shape, start_step=5)
    step, batch = next(pipe)
    step2, _ = next(pipe)
    pipe.close()
    assert (step, step2) == (5, 6)
    assert not pipe._thread.is_alive()
    np.testing.assert_array_equal(batch["tokens"],
                                  make_batch(cfg, shape, 5)["tokens"])


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def test_straggler_detection():
    det = ft.StragglerDetector(threshold=2.0)
    for _ in range(20):
        for w in ("w0", "w1", "w2", "w3"):
            det.observe(w, 1.0)
        det.observe("slow", 5.0)
    assert det.stragglers() == ["slow"]


def test_heartbeat_dead_workers(tmp_path):
    mon = ft.HeartbeatMonitor(str(tmp_path), timeout_seconds=60)
    mon.beat("w0")
    assert mon.dead_workers(["w0", "w1"]) == ["w1"]


def test_elastic_remesh_plan():
    plan = ft.plan_elastic_remesh(available_pods=3, pod_shape=(16, 16),
                                  global_batch=256, old_pods=4)
    assert plan.new_pods == 2 and plan.valid()
    assert plan.mesh_shape == (2, 16, 16)
    assert plan.per_pod_batch == 128
    single = ft.plan_elastic_remesh(1, (16, 16), 256, 2)
    assert single.mesh_shape == (16, 16)


def test_ft_manager_restart_decision(tmp_path):
    mgr = ft.FaultToleranceManager(
        heartbeat=ft.HeartbeatMonitor(str(tmp_path), timeout_seconds=60),
        stragglers=ft.StragglerDetector(),
        checkpoint_dir=str(tmp_path), workers=("w0", "w1"))
    mgr.on_step("w0", 1.0)
    assert mgr.should_restart()          # w1 never reported
    mgr.on_step("w1", 1.0)
    assert not mgr.should_restart()


# ---------------------------------------------------------------------------
# gradient compression, bf16 moments
# ---------------------------------------------------------------------------
def test_grad_compression_close_to_fp32():
    """bf16 gradient reduction tracks the fp32 path within bf16 tolerance."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = build(cfg)
    state = init_state(model, 0)
    batch = _batch(cfg, 4, 32)
    _, m1 = make_train_step(model, RunConfig())(state, batch)
    _, m2 = make_train_step(model, RunConfig(grad_compression=True))(
        state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=2e-2)


def test_bf16_moments_train_step_finite(tmp_path):
    cfg = get_smoke_config("qwen2-1.5b")
    model = build(cfg)
    state = init_state(model, 0, moment_dtype=torch.bfloat16)
    assert tree_leaves(state.opt.mu)[0].dtype == torch.bfloat16
    batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    state, metrics = make_train_step(model, RunConfig())(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert tree_leaves(state.opt.mu)[0].dtype == torch.bfloat16
    # the bf16 moments survive a checkpoint bit for bit
    save_checkpoint(str(tmp_path), 1, state)
    template = init_state(model, 0, device="meta",
                          moment_dtype=torch.bfloat16)
    _, restored = restore_checkpoint(str(tmp_path), template, device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
