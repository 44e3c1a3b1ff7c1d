"""Every model family of the port against the reference on the CPU: MoE
(granite), the Mamba2 hybrid (zamba2), xLSTM, the encoder-decoder
(seamless) and the VLM (pixtral) — the dense family is
``tests/test_torch_lm.py``'s — plus twins of ``tests/test_arch_smoke.py``
over all ten architectures on the port alone.

Parity runs the smoke configs in float32 compute with the reference's
weights (``params_from_reference``) and the same numpy-seeded inputs:
logits, caches and encoder outputs to ``rtol = atol = 1e-4`` (the
tolerance of ``tests/test_torch_lm.py``: float32 sums in another order
through a whole model), greedy tokens exactly.  Under ``attn_impl=
"flash"`` the reference runs its Pallas kernel in interpret mode and the
port K5's plain version (CPU tensors).  The reference's calls are jitted
here only to keep the file fast.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_get_smoke
from repro.models import build as r_build
from repro.models import encdec as r_encdec
from repro.train import serve as r_serve
from repro_torch import runtime
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build
from repro_torch.models import encdec as p_encdec
from repro_torch.models.convert import params_from_reference
from repro_torch.train import serve as p_serve

TOL = dict(rtol=1e-4, atol=1e-4)
#: one smoke config per family beyond dense, the ones with attention first
FAMILY_ARCHS = {"moe": "granite-moe-1b-a400m", "hybrid": "zamba2-1.2b",
                "audio": "seamless-m4t-large-v2", "vlm": "pixtral-12b",
                "ssm": "xlstm-350m"}
ATTENTION_ARCHS = [FAMILY_ARCHS[f] for f in ("moe", "hybrid", "audio", "vlm")]


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _cfgs(arch, **changes):
    changes = dict(compute_dtype="float32", **changes)
    return (dataclasses.replace(r_get_smoke(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """The reference's init of a smoke config (PRNGKey(0)), as numpy."""
    params = jax.jit(r_build(r_get_smoke(arch)).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _weights(cfg_r, cfg_p):
    params = _reference_params(cfg_p.arch_id[:-len("-smoke")])
    return params, params_from_reference(params, cfg_p, device="cpu")


def _inputs(cfg, b, s, seed=0):
    """(tokens, embeds): source frames for audio, patches for vlm."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    n_embeds = {"audio": s + 5, "vlm": cfg.n_patches}.get(cfg.family, 0)
    embeds = rng.standard_normal((b, n_embeds, cfg.d_model)).astype(
        np.float32) if n_embeds else None
    return tokens, embeds


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _close_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w)
    else:
        _close(got, want)


def _port_leaf(params_p, path):
    """The port's leaf at a reference tree path (a stacked leaf: the list
    of its layers' leaves)."""
    node = params_p
    for i, entry in enumerate(path):
        key = getattr(entry, "key", getattr(entry, "idx", None))
        if isinstance(node, list):     # an unrolled stack
            return [_port_leaf(layer, path[i:]) for layer in node]
        node = node[key]
    return node


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attn_impl,arch",
                         [("xla", a) for a in FAMILY_ARCHS.values()] +
                         [("flash", a) for a in ATTENTION_ARCHS])
def test_forward_matches_reference(attn_impl, arch):
    """Logits and aux loss (the dense family: tests/test_torch_lm.py)."""
    cfg_r, cfg_p = _cfgs(arch, attn_impl=attn_impl)
    params_r, params_p = _weights(cfg_r, cfg_p)
    tokens, embeds = _inputs(cfg_r, 2, 24)
    want, want_aux = jax.jit(r_build(cfg_r).forward)(params_r, _j(tokens),
                                                     embeds=_j(embeds))
    reset_launch_counts()
    got, aux = build(cfg_p).forward(params_p, _t(tokens), embeds=_t(embeds))
    assert got.shape == want.shape
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-5)
    assert launch_counts().get("flash_attention", 0) == 0   # CPU: plain


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_encode_and_prefill_cross_match_reference(attn_impl):
    cfg_r, cfg_p = _cfgs(FAMILY_ARCHS["audio"], attn_impl=attn_impl)
    params_r, params_p = _weights(cfg_r, cfg_p)
    _, src = _inputs(cfg_r, 2, 11, seed=4)
    _close(p_encdec.encode(params_p, _t(src), cfg_p),
           jax.jit(r_encdec.encode, static_argnums=2)(params_r, _j(src),
                                                      cfg_r))
    cache_r = r_encdec.prefill_cross(params_r, _j(src), cfg_r,
                                     r_encdec.init_cache(cfg_r, 2, 8,
                                                         src_len=16))
    cache_p = p_encdec.prefill_cross(params_p, _t(src), cfg_p,
                                     p_encdec.init_cache(cfg_p, 2, 8,
                                                         src_len=16,
                                                         device="cpu"))
    assert cache_p["xk"].shape == (cfg_p.n_layers, 2, 16, cfg_p.n_kv_heads,
                                   cfg_p.resolved_head_dim)
    _close_tree(cache_p, cache_r)


@pytest.mark.parametrize("family", ["hybrid", "ssm", "audio", "vlm"])
def test_decode_matches_reference(family):
    """Each decode step's logits and the whole cache: zamba2's Mamba
    states and shared-attention KV, xLSTM's block states, seamless after
    ``prefill_cross``, pixtral after the fused prefill with patches."""
    cfg_r, cfg_p = _cfgs(FAMILY_ARCHS[family])
    params_r, params_p = _weights(cfg_r, cfg_p)
    b, s, steps = 2, 6, 5
    tokens, embeds = _inputs(cfg_r, b, s + steps, seed=2)
    model_r, model_p = r_build(cfg_r), build(cfg_p)
    start, max_len = 0, s + steps
    if family == "audio":
        cache_r = r_encdec.prefill_cross(
            params_r, _j(embeds), cfg_r,
            model_r.init_cache(b, max_len, src_len=embeds.shape[1]))
        cache_p = p_encdec.prefill_cross(
            params_p, _t(embeds), cfg_p,
            model_p.init_cache(b, max_len, src_len=embeds.shape[1],
                               device="cpu"))
    elif family == "vlm":
        start, max_len = cfg_r.n_patches + s, cfg_r.n_patches + s + steps
        logits_r, cache_r = model_r.prefill(params_r, _j(tokens[:, :s]),
                                            max_len, embeds=_j(embeds))
        logits_p, cache_p = model_p.prefill(params_p, _t(tokens[:, :s]),
                                            max_len, embeds=_t(embeds))
        _close(logits_p, logits_r)
        tokens = tokens[:, s:]
    else:
        cache_r = model_r.init_cache(b, max_len)
        cache_p = model_p.init_cache(b, max_len, device="cpu")
    decode_r = jax.jit(model_r.decode_step)
    for t in range(tokens.shape[1]):
        _close_tree(cache_p, cache_r)
        pos = np.full((b,), start + t, np.int32)
        logits_r, cache_r = decode_r(params_r, cache_r, _j(tokens[:, t]),
                                     _j(pos))
        logits_p, cache_p = model_p.decode_step(params_p, cache_p,
                                                _t(tokens[:, t]), _t(pos))
        _close(logits_p, logits_r)
    _close_tree(cache_p, cache_r)


def _reference_prefilled(cfg_r, params_r, prompt, new, embeds=None):
    """The reference's fused prefill, then ``new - 1`` greedy decode
    steps: the tokens the port's launcher serves a transformer family."""
    model_r = r_build(cfg_r)
    start = prompt.shape[1] + (0 if embeds is None else embeds.shape[1])
    logits, cache = model_r.prefill(params_r, _j(prompt), start + new,
                                    embeds=_j(embeds))
    decode_r = jax.jit(model_r.decode_step)
    out = []
    for t in range(new):
        token = r_serve.greedy_sample(logits)
        out.append(np.asarray(token))
        if t < new - 1:
            logits, cache = decode_r(params_r, cache, token,
                                     jnp.full((len(prompt),), start + t,
                                              jnp.int32))
    return np.stack(out, axis=1)


def _rms(a, b):
    return float(np.sqrt(((a.astype(np.float64) - b) ** 2).mean()))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_bf16_decode_rounds_like_the_reference(arch):
    """In bf16 compute the stepped decode leaves the forward by bf16
    rounding alone, as the reference's does (its own gap passes its
    6e-2 by little here, and not at full width:
    scripts/bf16_decode_witness.py).  On the same weights and tokens:
    the port's decode-vs-forward gap (rms) within 1.25x the reference's
    (one rounding source, another order), and the port's bf16 decode no
    further (rms) from its float32 decode than 1.5x its bf16 forward from
    its float32 forward (``chip_smoke.py``'s BF16_DECODE_RATIO, held at
    full width on the card)."""
    params_r = _reference_params(arch)
    tokens = np.random.default_rng(0).integers(
        0, r_get_smoke(arch).vocab_size, (2, 16)).astype(np.int32)
    got = {}
    for dtype in ("bfloat16", "float32"):
        cfg_r = dataclasses.replace(r_get_smoke(arch), compute_dtype=dtype)
        cfg_p = dataclasses.replace(get_smoke_config(arch),
                                    compute_dtype=dtype)
        model_r, model_p = r_build(cfg_r), build(cfg_p)
        params_p = params_from_reference(params_r, cfg_p, device="cpu")
        step_r = jax.jit(model_r.decode_step)
        cache_r = model_r.init_cache(2, 16)
        cache_p = model_p.init_cache(2, 16, device="cpu")
        steps_r, steps_p = [], []
        for t in range(16):
            logits_r, cache_r = step_r(params_r, cache_r, _j(tokens[:, t]),
                                       jnp.full((2,), t, jnp.int32))
            with torch.no_grad():
                logits_p, cache_p = model_p.decode_step(
                    params_p, cache_p, _t(tokens[:, t]),
                    torch.full((2,), t, dtype=torch.int32))
            steps_r.append(np.asarray(logits_r, np.float32))
            steps_p.append(logits_p.float().numpy())
        with torch.no_grad():
            full_p = model_p.forward(params_p, _t(tokens))[0]
        got["reference", dtype] = (
            np.asarray(jax.jit(model_r.forward)(params_r, _j(tokens))[0],
                       np.float32), np.stack(steps_r, axis=1))
        got["port", dtype] = (full_p.float().numpy(),
                              np.stack(steps_p, axis=1))
    gap = {k: _rms(*got[k, "bfloat16"][::-1]) for k in ("reference", "port")}
    assert gap["port"] <= 1.25 * gap["reference"], gap
    (bf, bd), (ff, fd) = got["port", "bfloat16"], got["port", "float32"]
    assert _rms(bd, fd) <= 1.5 * _rms(bf, ff), (_rms(bd, fd), _rms(bf, ff))


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_generate_and_serve_batch_match_reference(family):
    """Greedy tokens equal the reference's ``generate`` (the prompt
    stepped); the launcher's equal the reference's fused prefill and
    decode for moe and vlm, its ``generate`` for the stepped families.
    (An MoE prefill routes the whole prompt at once, so its capacity and
    drops, and so its tokens, differ from stepping's.)"""
    cfg_r, cfg_p = _cfgs(FAMILY_ARCHS[family])
    params_r, params_p = _weights(cfg_r, cfg_p)
    prompt, _ = _inputs(cfg_r, 2, 5, seed=5)
    want = np.asarray(r_serve.generate(r_build(cfg_r), params_r,
                                       _j(prompt), max_new_tokens=5))
    got = p_serve.generate(build(cfg_p), params_p, _t(prompt),
                           max_new_tokens=5)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    out = serve_batch(cfg_p, prompt, 5, params=params_p, log=lambda _: None)
    if family in ("moe", "vlm"):
        want = _reference_prefilled(cfg_r, params_r, prompt, 5)
    else:
        want = want[:, 5:]
    np.testing.assert_array_equal(out["tokens"], want)


@pytest.mark.parametrize("family", ["audio", "hybrid", "ssm"])
def test_make_prefill_step_without_fused_prefill_matches_reference(family):
    """A family without a fused prefill: ``make_prefill_step`` returns
    the full forward's last-token logits and no cache, as the
    reference's; ``prefill`` steps the prompt into a cache instead, and
    its logits are the same last position's."""
    cfg_r, cfg_p = _cfgs(FAMILY_ARCHS[family])
    params_r, params_p = _weights(cfg_r, cfg_p)
    tokens, embeds = _inputs(cfg_r, 2, 7, seed=9)
    model_p = build(cfg_p)
    assert not model_p.has_prefill
    want, cache_r = r_serve.make_prefill_step(r_build(cfg_r), 16)(
        params_r, _j(tokens), _j(embeds))
    got, cache_p = p_serve.make_prefill_step(model_p, 16)(
        params_p, _t(tokens), _t(embeds))
    assert cache_r is None and cache_p is None
    _close(got, want)
    if family != "audio":      # stepping decodes without the source
        stepped, cache = p_serve.prefill(model_p, params_p, _t(tokens), 16)
        _close(stepped, want)
        assert cache is not None


def test_serve_batch_vlm_takes_patch_embeddings():
    """pixtral through the launcher with patches in front of the prompt:
    the prefill's logits equal the reference's prefill with embeds, and
    the next tokens its greedy decode from there."""
    cfg_r, cfg_p = _cfgs(FAMILY_ARCHS["vlm"])
    params_r, params_p = _weights(cfg_r, cfg_p)
    prompt, patches = _inputs(cfg_r, 2, 5, seed=7)
    want = _reference_prefilled(cfg_r, params_r, prompt, 4, embeds=patches)
    out = serve_batch(cfg_p, prompt, 4, params=params_p, embeds=patches,
                      log=lambda _: None)
    np.testing.assert_array_equal(out["tokens"], want)
    with pytest.raises(ValueError, match="embeds"):
        serve_batch(get_smoke_config("zamba2-1.2b"), prompt, 2,
                    embeds=patches, log=lambda _: None)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_params_from_reference_keeps_every_weight(family):
    """Bit for bit, leaf for leaf; the port's own init draws the same tree
    of shapes and dtypes; a stack of the wrong length raises."""
    arch = FAMILY_ARCHS[family]
    cfg_r, cfg_p = _cfgs(arch)
    params_r, params_p = _weights(cfg_r, cfg_p)
    own = build(cfg_p).init(0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(params_r)[0]
    assert len(flat) > 0
    for path, leaf in flat:
        got, mine = _port_leaf(params_p, path), _port_leaf(own, path)
        if isinstance(got, list):
            assert len(got) == leaf.shape[0] == len(mine)
            got, mine = torch.stack(got), torch.stack(mine)
        assert got.dtype == mine.dtype
        np.testing.assert_array_equal(got.numpy(), leaf)
        assert tuple(mine.shape) == leaf.shape
    assert type(params_p.get("blocks", ())) is tuple
    if family != "ssm":                # the xLSTM's blocks are not stacked
        bad = dataclasses.replace(cfg_p, n_layers=cfg_p.n_layers + 1)
        with pytest.raises(ValueError, match="stacked"):
            params_from_reference(params_r, bad, device="cpu")


# ---------------------------------------------------------------------------
# twins of tests/test_arch_smoke.py, on the port alone (bf16 compute)
# ---------------------------------------------------------------------------
def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_structure(v) for v in tree)
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_and_no_nans(arch):
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(0)
    tokens, embeds = _inputs(cfg, 2, 32 - (cfg.n_patches or 0)
                             if cfg.family == "vlm" else 16)
    logits, aux = model.forward(params, _t(tokens), embeds=_t(embeds))
    assert logits.shape[0] == 2 and logits.shape[-1] == cfg.vocab_size
    assert torch.isfinite(logits.float()).all()
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_shapes(arch):
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(0)
    b, max_len = 2, 16
    kw = {"src_len": 8} if cfg.family == "audio" else {}
    cache = model.init_cache(b, max_len, **kw)
    before = _structure(cache)
    token = torch.zeros((b,), dtype=torch.int32)
    pos = torch.zeros((b,), dtype=torch.int32)
    logits, cache2 = model.decode_step(params, cache, token, pos)
    assert logits.shape == (b, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    assert _structure(cache2) == before


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-1.5b", "bfloat16"), ("llama3-405b", "bfloat16"),
    ("xlstm-350m", "bfloat16"), ("zamba2-1.2b", "bfloat16"),
    ("granite-moe-1b-a400m", "float32")])
def test_decode_matches_forward(arch, dtype):
    """Step-by-step decode logits == full-sequence forward logits: in
    bf16 at the reference's tolerance (6e-2: the chunked-scan and
    one-token paths round differently); granite-moe in float32 at 1e-4,
    since in bf16 a router probability near a tie can pick another
    expert in the two paths.  granite-moe also runs at capacity factor
    E / k, where every expert can take every token: otherwise the
    forward's 16 tokens meet a capacity that one step's 2 tokens never
    reach, and the two routings drop different tokens by design."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tol = 6e-2 if dtype == "bfloat16" else 1e-4
    model = build(cfg)
    params = model.init(1)
    b, s = 2, 8
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32)
    full_logits, _ = model.forward(params, tokens)
    cache = model.init_cache(b, s)
    pos = torch.zeros((b,), dtype=torch.int32)
    for t in range(s):
        step_logits, cache = model.decode_step(params, cache, tokens[:, t],
                                               pos)
        pos = pos + 1
        np.testing.assert_allclose(step_logits.float().numpy(),
                                   full_logits[:, t].float().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_configs_match_assignment(arch):
    """The full (non-smoke) configs carry the exact published shapes."""
    cfg = get_config(arch)
    expect = {
        "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
        "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
        "qwen1.5-32b": (64, 5120, 40, 40, 27392, 152064),
        "qwen2-1.5b": (28, 1536, 12, 2, 8960, 151936),
        "llama3-405b": (126, 16384, 128, 8, 53248, 128256),
        "codeqwen1.5-7b": (32, 4096, 32, 32, 13440, 92416),
        "xlstm-350m": (24, 1024, 4, 4, 0, 50304),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256206),
        "pixtral-12b": (40, 5120, 32, 8, 14336, 131072),
    }[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == expect
    if arch == "phi3.5-moe-42b-a6.6b":
        assert cfg.moe and (cfg.moe.n_experts, cfg.moe.top_k) == (16, 2)
    if arch == "granite-moe-1b-a400m":
        assert cfg.moe and (cfg.moe.n_experts, cfg.moe.top_k) == (32, 8)
    if arch == "zamba2-1.2b":
        assert cfg.ssm_state == 64
    if arch == "pixtral-12b":
        assert cfg.resolved_head_dim == 160 and cfg.n_patches == 256
