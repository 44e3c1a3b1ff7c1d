"""Port vs reference: the qwen2-1.5b serving path on the CPU.

The same numpy-seeded inputs, and the same weights (the reference's
``init`` carried across by ``params_from_reference``), go through the JAX
package (its Pallas flash kernel in interpret mode) and through the port
(kernel K5's plain version ``attention_ref`` on CPU tensors).  Parity is
held in float32 compute, where the algorithm is the point: torch's and
XLA's CPU bf16 matmuls round differently, so bf16 is only held at the
reference's own loose tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as r_arch_ids
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke
from repro.kernels.flash_attention import ops as r_fa_ops
from repro.kernels.flash_attention.ref import attention_ref as r_attention
from repro.models import build as r_build
from repro.train import serve as r_serve
from repro_torch import runtime
from repro_torch.configs import (ARCH_IDS, ArchConfig, get_config,
                                 get_smoke_config)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import kernel as p_fa_kernel
from repro_torch.kernels.flash_attention import ops as p_fa_ops
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build
from repro_torch.models.convert import params_from_reference
from repro_torch.train import serve as p_serve

ARCH = "qwen2-1.5b"
TOL = dict(rtol=1e-4, atol=1e-4)       # float32 compute, port vs reference


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _cfgs(dtype="float32", attn_impl="xla"):
    """(reference cfg, port cfg): the smoke config at ``dtype`` compute."""
    r = dataclasses.replace(r_get_smoke(ARCH), compute_dtype=dtype,
                            attn_impl=attn_impl)
    p = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dtype,
                            attn_impl=attn_impl)
    return r, p


def _weights(cfg_r, cfg_p, seed=0):
    """The reference's init, with non-zero QKV biases so they count."""
    params = r_build(cfg_r).init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        b = params["layers"]["attn"][name]
        params["layers"]["attn"][name] = (
            0.1 * rng.standard_normal(b.shape)).astype(b.dtype)
    return params, params_from_reference(params, cfg_p, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# kernel K5's op: flash_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal", [
    (1, 4, 2, 128, 128, 32, True),      # GQA group 2
    (1, 2, 2, 200, 200, 16, True),      # ragged (the reference pads)
    (2, 4, 1, 100, 77, 16, False),      # ragged non-causal (reference: ref)
    (1, 4, 2, 64, 192, 16, False),      # kv longer than q
    (1, 4, 2, 200, 200, 160, True),     # pixtral's head dim, GQA, ragged
    (1, 2, 1, 100, 77, 160, False),     # head dim 160, ragged non-causal
])
def test_flash_attention_matches_reference(b, h, kh, sq, skv, d, causal):
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, skv, d)).astype(np.float32)
    got = p_fa_ops.flash_attention(*map(torch.as_tensor, (q, k, v)), causal)
    want = r_fa_ops.flash_attention(*map(jnp.asarray, (q, k, v)), causal,
                                    128, 128, True)
    oracle = r_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    _close(got, want, rtol=1e-5, atol=1e-5)
    _close(got, oracle, rtol=1e-5, atol=1e-5)
    # the model layout, read in place by the kernel
    bshd = p_fa_ops.flash_attention_bshd(
        *(torch.as_tensor(x).transpose(1, 2) for x in (q, k, v)), causal)
    _close(bshd.transpose(1, 2), want, rtol=1e-5, atol=1e-5)


def test_flash_attention_variant_by_input():
    """The tensor-core variant takes bf16 at D 64, 128 and 160 (pixtral's
    head dim); float32, and bf16 at any other D, take the tf32x3 one
    (float32 on the tensor cores); each has its own counter beside
    flash_attention."""
    assert p_fa_kernel.WGMMA_HEAD_DIMS == (64, 128, 160)
    for d in (64, 128, 160):
        assert p_fa_kernel.variant(torch.bfloat16, d) == "wgmma"
        assert p_fa_kernel.variant(torch.float32, d) == "tf32x3"
    for d in (1, 16, 24, 96, 192, 256):
        assert p_fa_kernel.variant(torch.bfloat16, d) == "tf32x3"
        assert p_fa_kernel.variant(torch.float32, d) == "tf32x3"
    names = {c.name for c in (p_fa_kernel.LAUNCHES,
                              *p_fa_kernel.VARIANT_LAUNCHES.values())}
    assert names == {"flash_attention", "flash_attention_wgmma",
                     "flash_attention_tf32x3"}


def test_flash_attention_causal_q_longer_than_ragged_kv():
    """Causal, Sq > Skv, Skv not a block multiple: the port masks keys past
    Skv and matches the reference's oracle.  (The reference op pads K/V
    with zeros there and lets rows >= Skv attend to the padding; see
    ROADMAP Queue 3.)"""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 2, 300, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1, 200, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1, 200, 16)).astype(np.float32)
    got = p_fa_ops.flash_attention(*map(torch.as_tensor, (q, k, v)), True)
    oracle = r_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    _close(got, oracle, rtol=1e-5, atol=1e-5)


def test_flash_attention_grad_matches_reference():
    """The op's backward (on CPU tensors attention_bwd_ref, from the
    forward's saved out and lse) against jax.grad of the reference's
    custom-VJP op."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 4, 72, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 72, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 72, 16)).astype(np.float32)
    w = rng.standard_normal((1, 4, 72, 16)).astype(np.float32)

    def loss_r(q, k, v):
        out = r_fa_ops.flash_attention(q, k, v, True, 128, 128, True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss_r, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (p_fa_ops.flash_attention(*ts, True) * torch.as_tensor(w)).sum().backward()
    for t, g in zip(ts, want):
        _close(t.grad, g, rtol=1e-5, atol=1e-5)


def test_flash_attention_routes_by_device():
    """CPU tensors take the plain version (no launch); the kernel wrapper
    refuses CPU tensors; meta tensors take the op's shape-only
    implementation (the dry run's), which the routes to the kernel and
    the plain version refuse."""
    x = torch.randn(1, 2, 8, 16)
    reset_launch_counts()
    p_fa_ops.flash_attention(x, x, x)
    assert launch_counts().get("flash_attention", 0) == 0
    with pytest.raises(ValueError):
        p_fa_kernel.flash_attention_kernel(x, x, x)
    meta = x.to("meta")
    out = p_fa_ops.flash_attention(meta, meta, meta)
    assert out.device.type == "meta" and out.shape == x.shape
    assert launch_counts().get("flash_attention", 0) == 0
    with pytest.raises(ValueError):
        p_fa_ops._forward(meta, meta, meta, True)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_forward_matches_reference(attn_impl):
    cfg_r, cfg_p = _cfgs(attn_impl=attn_impl)
    params_r, params_p = _weights(cfg_r, cfg_p)
    tokens = _tokens(cfg_r, 2, 128)
    want, _ = r_build(cfg_r).forward(params_r, jnp.asarray(tokens))
    reset_launch_counts()
    got, aux = build(cfg_p).forward(params_p, torch.as_tensor(tokens))
    assert got.shape == (2, 128, cfg_p.vocab_size) and float(aux) == 0.0
    _close(got, want)
    assert launch_counts().get("flash_attention", 0) == 0   # CPU: plain


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_and_decode_match_reference(attn_impl):
    """prefill's logits and padded KV cache, then each decode step's
    logits and cache, to 1e-4 in float32."""
    cfg_r, cfg_p = _cfgs(attn_impl=attn_impl)
    params_r, params_p = _weights(cfg_r, cfg_p, seed=1)
    b, s, max_len, steps = 2, 40, 48, 4
    tokens = _tokens(cfg_r, b, s + steps, seed=1)
    model_r, model_p = r_build(cfg_r), build(cfg_p)
    logits_r, cache_r = model_r.prefill(params_r, jnp.asarray(tokens[:, :s]),
                                        max_len)
    logits_p, cache_p = model_p.prefill(params_p,
                                        torch.as_tensor(tokens[:, :s]),
                                        max_len)
    assert cache_p["k"].shape == (cfg_p.n_layers, b, max_len,
                                  cfg_p.n_kv_heads, cfg_p.resolved_head_dim)
    _close(logits_p, logits_r)
    for name in ("k", "v"):
        _close(cache_p[name], cache_r[name])
    for t in range(s, s + steps):
        pos = np.full((b,), t, np.int32)
        logits_r, cache_r = model_r.decode_step(
            params_r, cache_r, jnp.asarray(tokens[:, t]), jnp.asarray(pos))
        logits_p, cache_p = model_p.decode_step(
            params_p, cache_p, torch.as_tensor(tokens[:, t]),
            torch.as_tensor(pos))
        _close(logits_p, logits_r)
        for name in ("k", "v"):
            _close(cache_p[name], cache_r[name])


def test_generate_matches_reference_float32():
    cfg_r, cfg_p = _cfgs()
    params_r, params_p = _weights(cfg_r, cfg_p, seed=2)
    prompt = _tokens(cfg_r, 2, 6, seed=2)
    want = r_serve.generate(r_build(cfg_r), params_r, jnp.asarray(prompt),
                            max_new_tokens=6)
    got = p_serve.generate(build(cfg_p), params_p, torch.as_tensor(prompt),
                           max_new_tokens=6)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the launcher (fused prefill, then decode) gives the same tokens
    out = serve_batch(cfg_p, prompt, 6, params=params_p, log=lambda _: None)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want)[:, 6:])


def test_generate_within_tolerance_bf16():
    """bf16 compute, at the reference's flash-vs-xla tolerance (5e-2):
    teacher-forced on the reference's tokens, every decode step's logits
    agree, and the port picks the reference's token wherever the
    reference's top-2 logits are further apart than twice the largest
    difference between the two packages' logits of that row (closer
    pairs may swap under bf16 rounding)."""
    cfg_r, cfg_p = _cfgs(dtype="bfloat16")
    params_r, params_p = _weights(cfg_r, cfg_p, seed=3)
    b, s, new = 2, 6, 6
    prompt = _tokens(cfg_r, b, s, seed=3)
    tokens = np.array(r_serve.generate(r_build(cfg_r), params_r,
                                       jnp.asarray(prompt),
                                       max_new_tokens=new))
    model_r, model_p = r_build(cfg_r), build(cfg_p)
    cache_r = model_r.init_cache(b, s + new)
    cache_p = model_p.init_cache(b, s + new, device="cpu")
    decided = 0
    for t in range(s + new - 1):
        pos = np.full((b,), t, np.int32)
        lr, cache_r = model_r.decode_step(params_r, cache_r,
                                          jnp.asarray(tokens[:, t]),
                                          jnp.asarray(pos))
        lp, cache_p = model_p.decode_step(params_p, cache_p,
                                          torch.as_tensor(tokens[:, t]),
                                          torch.as_tensor(pos))
        lr = np.asarray(lr, np.float32)
        _close(lp, lr, rtol=5e-2, atol=5e-2)
        if t >= s - 1:
            top2 = np.sort(lr, axis=-1)[:, -2:]
            diff = np.abs(lp.float().numpy() - lr).max(axis=-1)
            clear = top2[:, 1] - top2[:, 0] > 2 * diff
            got = p_serve.greedy_sample(lp).numpy()
            np.testing.assert_array_equal(got[clear], tokens[clear, t + 1])
            decided += int(clear.sum())
    assert decided > 0


def test_decode_matches_forward():
    """Step-by-step decode logits == full-sequence forward logits
    (tests/test_arch_smoke.py's check, on the port alone, bf16 compute)."""
    cfg = get_smoke_config(ARCH)
    model = build(cfg)
    params = model.init(1)
    b, s = 2, 8
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)),
        dtype=torch.int32)
    full_logits, _ = model.forward(params, tokens)
    cache = model.init_cache(b, s)
    pos = torch.zeros((b,), dtype=torch.int32)
    for t in range(s):
        step_logits, cache = model.decode_step(params, cache, tokens[:, t],
                                               pos)
        pos = pos + 1
        np.testing.assert_allclose(step_logits.float().numpy(),
                                   full_logits[:, t].float().numpy(),
                                   rtol=6e-2, atol=6e-2)


# ---------------------------------------------------------------------------
# configs, weights, registry, devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_match_reference(which):
    """All ten architectures, field for field; the fields the port alone
    has (Granite 4.0-H's) hold their defaults for them; an unknown id
    raises KeyError, as in the reference."""
    assert ARCH_IDS == r_arch_ids and len(ARCH_IDS) == 10
    defaults = {f.name: f.default for f in dataclasses.fields(ArchConfig)}
    for arch in ARCH_IDS:
        get_r = r_get_config if which == "config" else r_get_smoke
        get_p = get_config if which == "config" else get_smoke_config
        port = dataclasses.asdict(get_p(arch))
        ref = dataclasses.asdict(get_r(arch))
        assert {k: port[k] for k in ref} == ref
        assert {k: port[k] for k in port.keys() - ref.keys()} == \
            {k: defaults[k] for k in port.keys() - ref.keys()}
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab_size, full.resolved_head_dim) == \
        (28, 1536, 12, 2, 8960, 151936, 128)
    assert full.pdtype() == torch.float32 and full.cdtype() == torch.bfloat16
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_params_from_reference_keeps_every_weight():
    cfg_r, cfg_p = _cfgs()
    params_r, params_p = _weights(cfg_r, cfg_p)
    assert len(params_p["layers"]) == cfg_p.n_layers
    flat_r = jax.tree_util.tree_flatten_with_path(params_r)[0]
    for path, leaf in flat_r:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(cfg_p.n_layers):
                node = params_p["layers"][i]
                for k_ in keys[1:]:
                    node = node[k_]
                np.testing.assert_array_equal(node.numpy(), leaf[i])
        else:
            node = params_p
            for k_ in keys:
                node = node[k_]
            np.testing.assert_array_equal(node.numpy(), leaf)
    # the port's own init draws the same tree of shapes and dtypes
    own = build(cfg_p).init(0, device="cpu")
    for path, leaf in flat_r:
        keys = [p.key for p in path]
        node = own["layers"][0] if keys[0] == "layers" else own[keys[0]]
        for k_ in keys[1:]:
            node = node[k_]
        shape = leaf.shape[1:] if keys[0] == "layers" else leaf.shape
        assert tuple(node.shape) == shape and node.dtype == torch.float32
    with pytest.raises(ValueError):
        params_from_reference(params_r, dataclasses.replace(cfg_p,
                                                            n_layers=3),
                              device="cpu")


def test_unknown_family_raises():
    """As the reference's registry: ValueError naming the family."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        build(cfg)
    with pytest.raises(ValueError, match="rnn"):
        r_build(dataclasses.replace(r_get_smoke(ARCH), family="rnn"))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_r, cfg_p = _cfgs()
    model = build(cfg_p)
    prompt = _tokens(cfg_p, 1, 4)
    runtime.set_device(None)       # the autouse fixture restores "cpu"
    with pytest.raises(runtime.NoDeviceError):
        model.init(0)
    with pytest.raises(runtime.NoDeviceError):
        model.init_cache(1, 8)
    with pytest.raises(runtime.NoDeviceError):
        serve_batch(cfg_p, prompt, 2, log=lambda _: None)
    with pytest.raises(runtime.NoDeviceError):
        params_from_reference({"final_norm": {"scale": np.ones(4)}}, cfg_p)
    # asked for the CPU, the same calls run
    out = serve_batch(cfg_p, prompt, 2, device="cpu", log=lambda _: None)
    assert out["tokens"].shape == (1, 2)
