"""Granite 4.0-H on the port (``models/granite_hybrid.py``), on the CPU:
its configuration, the Mamba2 prefill's decode state, the chunked scan
with one group of B and C and in blocks of chunks, the spans of its
mixers and shared expert, and ``serve_batch`` through the fused prefill.
The model against its plain reference is in
``perfbench/tests/test_perfbench_granite_hybrid.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import runtime, tracing
from repro_torch.configs import (ARCH_IDS, PORT_ONLY, get_config,
                                 get_smoke_config)
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.models import ssm

ARCH = "granite-4.0-h-small"


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _smoke(**changes):
    return dataclasses.replace(get_smoke_config(ARCH),
                               compute_dtype="float32", **changes)


def test_the_config_has_the_published_numbers():
    cfg = get_config(ARCH)
    assert ARCH in PORT_ONLY and ARCH not in ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.vocab_size) == \
        (40, 4096, 32, 8, 128, 100352)
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.d_ff,
            cfg.shared_expert_ff) == (72, 10, 768, 1536)
    assert ssm.mamba2_dims(cfg) == (8192, 64, 128, 128)
    assert (cfg.ssm_chunk, cfg.rope, cfg.embedding_multiplier,
            cfg.attention_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling) == (256, False, 12.0, 0.0078125, 0.22, 16.0)
    assert ssm.mamba2_dims(get_config("zamba2-1.2b"))[1] == 64


def test_the_mamba2_prefill_state_is_the_stepped_decodes():
    """The scan's final state and the conv's last inputs after a prompt
    in one pass equal those of the decode step taken a token at a time
    (float32 sums in another order), and so does the output."""
    cfg = _smoke()
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_mamba2(gen, cfg, "cpu")
    p["A_log"] = torch.rand(p["A_log"].shape, generator=gen) * 2.0
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen) - 3.0
    x = torch.randn(2, 19, cfg.d_model, generator=gen)
    out, state = ssm.mamba2_prefill(p, x, cfg)
    step = ssm.mamba2_init_state(cfg, 2, "cpu")
    outs = []
    for t in range(x.shape[1]):
        y, step = ssm.mamba2_step(p, x[:, t:t + 1], step, cfg)
        outs.append(y)
    assert set(state) == set(step)
    for k in state:
        assert state[k].shape == step[k].shape and \
            state[k].dtype == step[k].dtype
        assert torch.allclose(state[k], step[k], atol=1e-5, rtol=1e-5), k
    assert torch.allclose(out, torch.cat(outs, dim=1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block", [ssm.SCAN_BLOCK_ELEMENTS, 64 * 8 * 8])
def test_one_group_of_b_and_c_is_every_head_reading_it(monkeypatch, block):
    """B and C given once for a group of heads give what they give copied
    to every head, whether the chunks are taken at once or a few at a
    time."""
    g = torch.Generator().manual_seed(3)
    b, s, h, p, n = 2, 37, 6, 4, 5
    x = torch.randn(b, s, h, p, generator=g)
    B = torch.randn(b, s, 2, n, generator=g)
    C = torch.randn(b, s, 2, n, generator=g)
    loga = -torch.rand(b, s, h, generator=g)
    h0 = torch.randn(b, h, n, p, generator=g)
    want_y, want_h = ssm.chunked_linear_scan(
        x, B.repeat_interleave(3, 2), C.repeat_interleave(3, 2), loga, 8, h0)
    monkeypatch.setattr(ssm, "SCAN_BLOCK_ELEMENTS", block)
    got_y, got_h = ssm.chunked_linear_scan(x, B, C, loga, 8, h0)
    assert torch.allclose(got_y, want_y, atol=1e-6)
    assert torch.allclose(got_h, want_h, atol=1e-6)


def test_each_mixer_and_shared_expert_is_a_span():
    cfg = _smoke()
    model = build(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 11),
                           generator=torch.Generator().manual_seed(1))
    names = ("mamba2", "chunked_linear_scan", "moe.shared", "moe_ffn")
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.prefill(params, tokens, 12)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name in names)
    got = {n: [s for s in spans if s[2] == n] for n in names}
    n_mamba = cfg.layer_types.count("mamba")
    assert len(got["mamba2"]) == len(got["chunked_linear_scan"]) == n_mamba
    assert len(got["moe.shared"]) == len(got["moe_ffn"]) == cfg.n_layers
    for lo, hi, _ in got["chunked_linear_scan"]:
        assert any(a <= lo and hi <= b for a, b, _ in got["mamba2"])
    for (lo, _, _), (_, hi, _) in zip(got["moe.shared"], got["moe_ffn"]):
        assert hi <= lo                 # the shared expert after moe_ffn
    tracing.reset_tallies()


def test_serve_batch_prefills_in_one_pass(monkeypatch):
    """``serve_batch`` takes the fused prefill (no step through the
    decode closure over the prompt), then decodes from its cache: the
    tokens are the greedy ones of the full forward over what it served
    (no capacity drops, so the two route alike)."""
    cfg = _smoke(moe=dataclasses.replace(get_smoke_config(ARCH).moe,
                                         capacity_factor=8 / 3))
    model = build(cfg)
    assert model.has_prefill

    def no_stepping(*_a, **_k):
        raise AssertionError("the prompt was stepped through decode")
    monkeypatch.setattr("repro_torch.train.serve.step_prompt", no_stepping)
    params = model.init(0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    out = serve.serve_batch(cfg, prompts, 4, params=params, device="cpu",
                            log=lambda *_: None)
    seq = np.concatenate([prompts, out["tokens"][:, :-1]], axis=1)
    with torch.no_grad():
        logits, _ = model.forward(params, torch.as_tensor(seq))
    assert (logits[:, 8:].argmax(-1).numpy() == out["tokens"]).all()
