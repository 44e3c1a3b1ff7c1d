"""Granite 4.0-H's plain reference (``reference/granite_hybrid.py``)
against a token-by-token recurrence, and against the program in float32
at the ``smoke()`` size: whole forwards, the fused prefill followed by
decode steps through the cache, each multiplier and the shared expert,
and the control's float8 products."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench.reference import decoder
from perfbench.reference import granite_hybrid as gh

#: the widest gap allowed between the program and the reference in
#: float32: sums in another order (the two read 1e-7 apart at this size,
#: where the logits reach ~0.3); each multiplier, the shared expert and
#: float8 products move the logits by 0.03 or more, 10^4 times this
TOL = 2e-6


def _program_cfg(**changes):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("granite-4.0-h-small")
    moe = changes.pop("moe", {})
    return dataclasses.replace(cfg, compute_dtype="float32",
                               attn_impl="flash",
                               moe=dataclasses.replace(cfg.moe, **moe),
                               **changes)


def model_dict(cfg) -> dict:
    """The reference's ``model`` numbers of a program config."""
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "tie_word_embeddings": cfg.tie_embeddings,
            "num_local_experts": cfg.moe.n_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "capacity_factor": cfg.moe.capacity_factor,
            "layer_types": list(cfg.layer_types),
            "shared_intermediate_size": cfg.shared_expert_ff,
            "mamba_n_heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
            "mamba_d_head": cfg.ssm_head_dim, "mamba_d_state": cfg.ssm_state,
            "mamba_n_groups": 1, "mamba_chunk_size": cfg.ssm_chunk,
            "mamba_d_conv": 4, "mamba_expand": cfg.ssm_expand,
            "embedding_multiplier": cfg.embedding_multiplier,
            "attention_multiplier": cfg.attention_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling}


#: init scales for every leaf: decays that carry over several chunks
#: (A ~ e^1, dt ~ softplus(-3)), the rest of order one after the norms
INIT = {n: {"std": 0.2} for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                  "w_down", "router", "in_proj", "out_proj")}
INIT.update(tok={"std": 0.1}, scale={"mean": 1.0, "std": 0.1},
            norm_scale={"mean": 1.0, "std": 0.1}, conv_w={"std": 0.3},
            conv_b={"std": 0.2}, A_log={"mean": 1.0, "std": 0.5},
            dt_bias={"mean": -3.0, "std": 1.0},
            D_skip={"mean": 1.0, "std": 0.1})


def _weights(cfg, seed=11):
    """(the program's model, its parameters, the same values by path)."""
    from repro_torch.models import build
    from perfbench.yardstick import weights
    model = build(cfg)
    template = model.init(0, device="meta")
    by_path = weights.draw(weights.layout(template), INIT, seed,
                           torch.device("cpu"))
    return model, weights.rebuild(template, by_path), by_path


def _tokens(b=3, s=21, seed=1):
    return torch.randint(0, 256, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _program_logits(cfg, change=None):
    """(the program's logits, its weights by path), the weights first
    passed through ``change``."""
    from repro_torch import runtime
    from perfbench.yardstick import weights
    model, _, by_path = _weights(cfg)
    if change is not None:
        by_path = change(by_path)
    params = weights.rebuild(model.init(0, device="meta"), by_path)
    with runtime.use_device("cpu"), torch.no_grad():
        return model.forward(params, _tokens())[0], by_path


def test_reference_logits_are_the_programs_in_float32():
    cfg = _program_cfg()
    got, W = _program_logits(cfg)
    ref = gh.GraniteHybrid(model_dict(cfg))
    want = ref.all_logits(W, _tokens())
    assert (got - want).abs().max() <= TOL
    assert torch.allclose(ref.last_logits(W, _tokens()), want[:, -1],
                          atol=TOL, rtol=0)


def test_fused_prefill_then_decode_is_the_references_full_forward():
    """The prompt through the fused prefill, then a token a step through
    the cache, against the reference's forward over prompt and new
    tokens at once.  The experts' capacity is made to hold every
    assignment (factor E / k), so routing the prompt whole and a token a
    step keep the same assignments."""
    from repro_torch import runtime
    cfg = _program_cfg(moe={"capacity_factor": 8 / 3})
    model, params, W = _weights(cfg)
    tokens = _tokens(b=2, s=23, seed=5)
    prompt = 13
    want = gh.GraniteHybrid(model_dict(cfg)).all_logits(W, tokens)
    with runtime.use_device("cpu"), torch.no_grad():
        logits, cache = model.prefill(params, tokens[:, :prompt], 23)
        got = [logits]
        pos = torch.full((2,), prompt, dtype=torch.int32)
        for t in range(prompt, 22):
            logits, cache = model.decode_step(params, cache, tokens[:, t],
                                              pos)
            got.append(logits)
            pos = pos + 1
    got = torch.stack(got, dim=1)
    assert (got - want[:, prompt - 1:22]).abs().max() <= TOL


@pytest.mark.parametrize("change", [
    {"embedding_multiplier": 3.0}, {"attention_multiplier": 0.3},
    {"residual_multiplier": 0.6}, {"logits_scaling": 4.0}, "shared"])
def test_each_multiplier_and_the_shared_expert_moves_both_alike(change):
    """Each multiplier at another value, and the shared expert taken out
    (its down projection zero), move the program's logits by far more than
    ``TOL``, and the reference's with them."""
    before, _ = _program_logits(_program_cfg())
    if change == "shared":
        cfg = _program_cfg()
        after, W = _program_logits(cfg, lambda by_path: {
            k: torch.zeros_like(v) if ".shared.w_down" in k else v
            for k, v in by_path.items()})
    else:
        cfg = _program_cfg(**change)
        after, W = _program_logits(cfg)
    want = gh.GraniteHybrid(model_dict(cfg)).all_logits(W, _tokens())
    assert (after - before).abs().max() > 1000 * TOL
    assert (after - want).abs().max() <= TOL


def test_float8_products_fail_the_float32_agreement():
    cfg = _program_cfg()
    got, W = _program_logits(cfg)
    low = gh.GraniteHybrid(model_dict(cfg), decoder.Matmul("fp8"))
    assert (low.all_logits(W, _tokens()) - got).abs().max() > 1000 * TOL


def _recurrence(X, A, B, C):
    """The SSM a token at a time: h_t = exp(A_t) h_{t-1} + x_t B_t^T,
    y_t = h_t C_t, each head reading its group's B and C."""
    b, s, h, p = X.shape
    g, n = B.shape[2:]
    grp = torch.arange(h) // (h // g)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    ys = []
    for t in range(s):
        state = torch.exp(A[:, t])[..., None, None] * state + \
            X[:, t, :, :, None] * B[:, t, grp, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t, grp]))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("s, chunk, groups", [(21, 8, 1), (32, 8, 2),
                                              (5, 8, 4)])
def test_reference_ssd_is_the_token_by_token_recurrence(s, chunk, groups):
    g = torch.Generator().manual_seed(s + chunk)
    b, h, p, n = 2, 4, 3, 5
    X = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    A = -torch.rand(b, s, h, generator=g, dtype=torch.float64)
    B = torch.randn(b, s, groups, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, s, groups, n, generator=g, dtype=torch.float64)
    want_y, want_h = _recurrence(X, A, B, C)
    got_y, got_h = gh.ssd(X, A, B, C, chunk)
    assert torch.allclose(got_y, want_y, atol=1e-10)
    assert torch.allclose(got_h, want_h, atol=1e-10)
