"""Per-architecture training smoke tests of the port: the twins of
``tests/test_arch_smoke.py``'s ``test_train_step_finite_loss`` (all ten
configs) and ``test_loss_decreases_over_steps``, on the CPU at the smoke
configs, with the reference's numpy-seeded batches."""
import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import build
from repro_torch.train.loop import init_state, make_train_step


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _smoke_batch(cfg, b=2, s=32, seed=0):
    """The reference test's batch: audio gets half the sequence as source
    frames, a VLM its patches in front of the text."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        out = {
            "tokens": rng.integers(0, cfg.vocab_size, (b, s // 2)
                                   ).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s // 2)
                                   ).astype(np.int32),
            "embeds": rng.standard_normal((b, s // 2, cfg.d_model)
                                          ).astype(np.float32)}
    elif cfg.family == "vlm":
        txt = s - cfg.n_patches
        out = {
            "tokens": rng.integers(0, cfg.vocab_size, (b, txt)
                                   ).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, txt)
                                   ).astype(np.int32),
            "embeds": rng.standard_normal((b, cfg.n_patches, cfg.d_model)
                                          ).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                      ).astype(np.int32),
               "labels": rng.integers(0, cfg.vocab_size, (b, s)
                                      ).astype(np.int32)}
    return {k: torch.as_tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_finite_loss(arch):
    cfg = get_smoke_config(arch)
    model = build(cfg)
    state = init_state(model, 0, device="cpu")
    step = make_train_step(model, RunConfig())
    state, metrics = step(state, _smoke_batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "xlstm-350m", "zamba2-1.2b"])
def test_loss_decreases_over_steps(arch):
    cfg = get_smoke_config(arch)
    model = build(cfg)
    state = init_state(model, 0, device="cpu")
    run = RunConfig(learning_rate=3e-3, warmup_steps=1, total_steps=30)
    step = make_train_step(model, run)
    batch = _smoke_batch(cfg, b=4)
    first = None
    for _ in range(8):
        state, metrics = step(state, batch)  # same batch: must memorize
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first
