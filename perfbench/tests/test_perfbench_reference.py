"""The plain reference against hand-checked cases, and against the
program in float32 at a small size (the two implement one semantics)."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from perfbench.reference import decoder

SMALL = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 8, "intermediate_size": 48,
         "vocab_size": 64, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
         "tie_word_embeddings": True}
SMALL_MOE = dict(SMALL, num_local_experts=4, num_experts_per_tok=2,
                 capacity_factor=1.25, intermediate_size=16,
                 router_aux_loss_coef=0.01)


def test_rmsnorm_by_hand():
    dec = decoder.Decoder(SMALL)
    x = torch.tensor([[3.0, 4.0]])
    got = dec.rmsnorm(x, torch.tensor([1.0, 2.0]))
    rms = math.sqrt((9 + 16) / 2 + 1e-6)
    assert torch.allclose(got, torch.tensor([[3 / rms, 8 / rms]]))


def test_rope_rotates_each_pair_by_position_times_frequency():
    dec = decoder.Decoder(dict(SMALL, head_dim=4, rope_theta=100.0))
    x = torch.zeros(1, 3, 1, 4)
    x[..., 0] = 1.0                           # pair (0, 2), frequency 1
    x[..., 1] = 1.0                           # pair (1, 3), frequency 1/10
    got = dec.rope(x)[0, :, 0]
    for p in range(3):
        want = [math.cos(p), math.cos(p / 10), math.sin(p), math.sin(p / 10)]
        assert torch.allclose(got[p], torch.tensor(want), atol=1e-6)


def test_attention_is_causal_grouped_and_scaled():
    torch.manual_seed(0)
    dec = decoder.Decoder(SMALL)
    d, hd = 32, 8
    W = {"layers.0.attn.wq": torch.randn(d, 4, hd),
         "layers.0.attn.wk": torch.randn(d, 2, hd),
         "layers.0.attn.wv": torch.randn(d, 2, hd),
         "layers.0.attn.wo": torch.randn(4, hd, d)}
    h = torch.randn(1, 5, d)
    got = dec.attention(W, 0, h)
    q = dec.rope(torch.einsum("bsd,dhk->bshk", h, W["layers.0.attn.wq"]))
    k = dec.rope(torch.einsum("bsd,dhk->bshk", h, W["layers.0.attn.wk"]))
    v = torch.einsum("bsd,dhk->bshk", h, W["layers.0.attn.wv"])
    out = torch.zeros(1, 5, 4, hd)
    for t in range(5):                        # position by position
        for head in range(4):
            kv = head // 2                    # heads 0, 1 share kv head 0
            s = torch.stack([q[0, t, head] @ k[0, j, kv]
                             for j in range(t + 1)]) / math.sqrt(hd)
            p = torch.softmax(s, 0)
            out[0, t, head] = sum(p[j] * v[0, j, kv] for j in range(t + 1))
    want = torch.einsum("bshk,hkd->bsd", out, W["layers.0.attn.wo"])
    assert torch.allclose(got, want, atol=1e-4)


def test_moe_keeps_each_experts_first_tokens_up_to_capacity():
    dec = decoder.Decoder(dict(SMALL_MOE, hidden_size=2, num_local_experts=2,
                               num_experts_per_tok=1, capacity_factor=0.5))
    assert dec.capacity(4) == 1               # ceil(4 x 1 x 0.5 / 2)
    # tokens 0, 1 go to expert 0 and tokens 2, 3 to expert 1
    h = torch.tensor([[[1.0, 0.0], [2.0, 0.0], [0.0, 1.0], [0.0, 3.0]]])
    p = "layers.0.moe."
    W = {p + "router": torch.tensor([[10.0, -10.0], [-10.0, 10.0]]),
         p + "w_gate": torch.ones(2, 2, 1) * 5.0,
         p + "w_up": torch.ones(2, 2, 1),
         p + "w_down": torch.tensor([[[1.0, 0.0]], [[0.0, 1.0]]])}
    y, aux = dec.moe(W, 0, h)
    f = lambda s: torch.nn.functional.silu(torch.tensor(5.0 * s)) * s
    # gates renormalised over top-1 are 1; tokens 1 and 3 are dropped
    want = torch.tensor([[f(1.0), 0.0], [0.0, 0.0], [0.0, f(1.0)],
                         [0.0, 0.0]])
    assert torch.allclose(y[0], want, atol=1e-5)
    # Switch loss: E x sum(density x mean probability) ~ 2 x (0.5 + 0.5)/2
    assert aux.item() == pytest.approx(1.0, abs=1e-4)


def test_one_adamw_step_by_hand():
    dec = decoder.Decoder(SMALL)
    opt = {"learning_rate": 1e-2, "warmup_steps": 1, "total_steps": 10,
           "weight_decay": 0.1, "grad_clip": 1e9, "b1": 0.9, "b2": 0.95,
           "eps": 1e-8}
    assert decoder.learning_rate(1, opt) == pytest.approx(1e-2)
    assert decoder.learning_rate(10, opt) == pytest.approx(1e-3)
    w0 = torch.tensor([0.5, -2.0])

    class Square(decoder.Decoder):
        def loss(self, W, tokens, labels):
            total = (W["w"] ** 2).sum()
            return total, total

    W = {"w": w0.clone()}
    got = decoder.train(Square(SMALL), W, [{"tokens": None, "labels": None}],
                        opt)
    g = 2 * w0
    m, v = 0.1 * g, 0.05 * g * g
    step = (m / 0.1) / (torch.sqrt(v / 0.05) + 1e-8)
    want = w0 - 1e-2 * (step + 0.1 * w0)
    assert torch.allclose(W["w"], want)
    assert got["first_grad"]["w"] == pytest.approx(float(g.norm()))
    assert got["losses"] == [pytest.approx(float((w0 ** 2).sum()))]
    del dec


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, -3.0, 0.1])
    got = decoder.fp8_round(x)
    assert got[0] == 448.0 and got[2] == -3.0
    assert torch.all((got - x).abs() <= x.abs() * 2 ** -4 + 1e-3)
    mm = decoder.Matmul("fp8")
    a = torch.randn(8, 8, requires_grad=True)
    b = torch.randn(8, 8)
    mm(a, b).sum().backward()
    assert a.grad is not None
    with pytest.raises(ValueError):
        decoder.Matmul("int4")


# ---- the reference and the program, one semantics --------------------------
def _program(cfg_over, model):
    from repro_torch.configs import get_config
    cfg = get_config("granite-moe-1b-a400m" if "num_local_experts" in model
                     else "qwen2-1.5b")
    over = dict(cfg_over, compute_dtype="float32", param_dtype="float32",
                attn_impl="flash", remat=False)
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return dataclasses.replace(cfg, **over)


def _weights(cfg, seed):
    from repro_torch.models import build
    from perfbench.yardstick import weights
    model = build(cfg)
    template = model.init(0, device="meta")
    init = {n: {"std": 0.2} for n in ("tok", "wq", "wk", "wv", "wo", "bq",
                                      "bk", "bv", "w_gate", "w_up", "w_down",
                                      "router")}
    init["scale"] = {"mean": 1.0, "std": 0.1}
    spec = weights.layout(template)
    by_path = weights.draw(spec, init, seed, torch.device("cpu"))
    return model, template, by_path


PORT_SMALL = {"d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 8, "d_ff": 48, "vocab_size": 64,
              "rope_theta": 10000.0, "norm_eps": 1e-6, "tie_embeddings": True}


@pytest.mark.parametrize("moe", [False, True])
def test_reference_logits_are_the_programs_in_float32(moe):
    from repro_torch import runtime
    from perfbench.yardstick import weights
    model_cfg = SMALL_MOE if moe else dict(SMALL, qkv_bias=True)
    over = dict(PORT_SMALL, qkv_bias=not moe)
    if moe:
        over.update(d_ff=16, moe={"n_experts": 4, "top_k": 2})
    cfg = _program(over, model_cfg)
    model, template, by_path = _weights(cfg, 11)
    tokens = torch.randint(0, 64, (3, 12), generator=torch.Generator()
                           .manual_seed(1))
    with runtime.use_device("cpu"):
        logits, _ = model.forward(weights.rebuild(template, by_path), tokens)
    ref = decoder.Decoder(model_cfg)
    x, _ = ref.hidden(by_path, tokens)
    want = ref.logits(by_path, x.reshape(-1, 32)).reshape(3, 12, 64)
    assert torch.allclose(logits, want, atol=2e-5, rtol=2e-5)
    assert torch.allclose(ref.last_logits(by_path, tokens), want[:, -1],
                          atol=2e-5, rtol=2e-5)


def test_reference_training_steps_are_the_programs_in_float32():
    from repro_torch import runtime
    from repro_torch.configs.base import RunConfig
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import TrainState, make_train_step
    from perfbench.yardstick import weights
    cfg = _program(dict(PORT_SMALL, qkv_bias=True), SMALL)
    model, template, by_path = _weights(cfg, 5)
    run = RunConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    opt = {"learning_rate": 1e-2, "warmup_steps": 2, "total_steps": 10,
           "weight_decay": run.weight_decay, "grad_clip": run.grad_clip,
           "b1": run.b1, "b2": run.b2, "eps": 1e-8}
    g = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, 64, (2, 16), generator=g),
                "labels": torch.randint(0, 64, (2, 16), generator=g)}
               for _ in range(2)]
    params = weights.rebuild(template, {k: v.clone()
                                        for k, v in by_path.items()})
    state = TrainState(params, adamw_init(params))
    step = make_train_step(model, run)
    losses = []
    with runtime.use_device("cpu"):
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    W = {k: v.clone() for k, v in by_path.items()}
    got = decoder.train(decoder.Decoder(dict(SMALL, qkv_bias=True)), W,
                        batches, opt)
    assert got["losses"] == pytest.approx(losses, rel=1e-5)
    for path, p in weights.leaf_paths(state.params):
        assert torch.allclose(p, W[path], atol=1e-5), path
