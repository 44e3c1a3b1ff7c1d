"""Port vs reference: the MoE layer (``models/moe.py``) and the MoE
transformer on the CPU.

The same weights (the reference's ``init_moe`` / ``init``, carried across
by ``params_from_reference``) and the same numpy-seeded activations go
through both packages in float32 compute.  Tolerances: outputs and the
auxiliary loss 1e-5 (float32 sums in another order); the router's
choices — each token's top-k experts and each expert's capacity slots —
exactly.  The reference does not return its routing, so
:func:`_reference_routing` repeats its lines (``repro/models/moe.py``
:58-79) in ``jax.numpy``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_get_smoke
from repro.models import build as r_build
from repro.models import moe as r_moe
from repro_torch import runtime
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import build
from repro_torch.models import moe as p_moe
from repro_torch.models.convert import params_from_reference

TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)     # whole-model logits (test_torch_lm)
ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _cfgs(arch, **changes):
    changes = dict(compute_dtype="float32", **changes)
    return (dataclasses.replace(r_get_smoke(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _moe_params(cfg_r, seed):
    params = jax.tree.map(np.asarray,
                          r_moe.init_moe(jax.random.PRNGKey(seed), cfg_r))
    return params, {k: torch.tensor(v) for k, v in params.items()}


def _reference_routing(params, xt, cfg):
    """The reference's gate top-k and capacity selection, line for line."""
    moe = cfg.moe
    t = xt.shape[0]
    c = r_moe.capacity(t, cfg)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        params["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, moe.top_k)
    mask = jax.nn.one_hot(gate_idx, moe.n_experts,
                          dtype=jnp.float32).sum(axis=1)
    priority = mask.T * (t * 2.0) - jnp.arange(t, dtype=jnp.float32)[None, :]
    token_ids = jax.lax.top_k(priority, c)[1]
    return probs, gate_idx, token_ids


def _assert_no_gate_ties(probs, k):
    """The k-th and (k+1)-th router probabilities of every token are
    apart, so the exact comparison of the choices is meaningful."""
    top = -np.sort(-probs, axis=-1)
    assert (top[:, :k] - top[:, 1:k + 1]).min() > 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(arch, capacity_factor):
    """Output and aux loss to 1e-5; gate_idx and token_ids exactly; at
    capacity factor 0.5 tokens are dropped, and the same ones."""
    cfg_r, cfg_p = _cfgs(arch)
    moe = dataclasses.replace(cfg_r.moe, capacity_factor=capacity_factor)
    cfg_r = dataclasses.replace(cfg_r, moe=moe)
    cfg_p = dataclasses.replace(cfg_p, moe=MoEConfig(**vars(moe)))
    params_r, params_p = _moe_params(cfg_r, seed=3)
    x = np.random.default_rng(3).standard_normal(
        (2, 24, cfg_r.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(r_moe.moe_ffn, static_argnums=2)(
        params_r, jnp.asarray(x), cfg_r)
    got_y, got_aux = p_moe.moe_ffn(params_p, torch.as_tensor(x), cfg_p)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)

    xt = x.reshape(-1, cfg_r.d_model)
    probs, gate_idx, token_ids = jax.jit(_reference_routing,
                                         static_argnums=2)(
        params_r, jnp.asarray(xt), cfg_r)
    _assert_no_gate_ties(np.asarray(probs), cfg_r.moe.top_k)
    r = p_moe.route(params_p, torch.as_tensor(xt), cfg_p)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(r["token_ids"].numpy(), token_ids)
    n_assigned = xt.shape[0] * cfg_r.moe.top_k
    if capacity_factor < 1:
        assert 0 < p_moe.dropped(r) < n_assigned
    else:
        assert p_moe.dropped(r) >= 0


@pytest.mark.parametrize("n_tokens", [1, 2, 7, 64, 1000, 8192])
def test_capacity_matches_reference(n_tokens):
    for arch in ARCHS:
        cfg_r, cfg_p = _cfgs(arch)
        assert p_moe.capacity(n_tokens, cfg_p) == \
            r_moe.capacity(n_tokens, cfg_r)


def test_init_moe_shapes_and_dtypes():
    cfg_r, cfg_p = _cfgs(ARCHS[0])
    want = r_moe.init_moe(jax.random.PRNGKey(0), cfg_r)
    gen = torch.Generator().manual_seed(0)
    got = p_moe.init_moe(gen, cfg_p, "cpu")
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype)


def _weights(cfg_r, cfg_p, seed):
    params = jax.tree.map(np.asarray,
                          r_build(cfg_r).init(jax.random.PRNGKey(seed)))
    return params, params_from_reference(params, cfg_p, device="cpu")


def test_moe_prefill_and_decode_match_reference():
    """granite-moe's fused prefill on the flash path (logits and KV
    cache), then decode steps, to 1e-4 in float32; the forward's aux loss
    to 1e-5.  (The plain attention path's forward is in
    tests/test_torch_families.py.)"""
    cfg_r, cfg_p = _cfgs(ARCHS[0], attn_impl="flash")
    params_r, params_p = _weights(cfg_r, cfg_p, seed=1)
    b, s, max_len, steps = 2, 24, 32, 2
    tokens = np.random.default_rng(1).integers(
        0, cfg_r.vocab_size, (b, s + steps)).astype(np.int32)
    model_r, model_p = r_build(cfg_r), build(cfg_p)
    _, aux_r = jax.jit(model_r.forward)(params_r, jnp.asarray(tokens[:, :s]))
    _, aux_p = model_p.forward(params_p, torch.as_tensor(tokens[:, :s]))
    assert float(aux_p) > 0
    np.testing.assert_allclose(float(aux_p), float(aux_r), **TOL)
    logits_r, cache_r = jax.jit(model_r.prefill, static_argnums=2)(
        params_r, jnp.asarray(tokens[:, :s]), max_len)
    decode_r = jax.jit(model_r.decode_step)
    logits_p, cache_p = model_p.prefill(params_p,
                                        torch.as_tensor(tokens[:, :s]),
                                        max_len)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r),
                               **LM_TOL)
    for t in range(s, s + steps):
        for name in ("k", "v"):
            np.testing.assert_allclose(cache_p[name].numpy(),
                                       np.asarray(cache_r[name]), **LM_TOL)
        pos = np.full((b,), t, np.int32)
        logits_r, cache_r = decode_r(
            params_r, cache_r, jnp.asarray(tokens[:, t]), jnp.asarray(pos))
        logits_p, cache_p = model_p.decode_step(
            params_p, cache_p, torch.as_tensor(tokens[:, t]),
            torch.as_tensor(pos))
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r),
                                   **LM_TOL)
