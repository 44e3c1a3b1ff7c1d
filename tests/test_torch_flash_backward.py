"""Kernel K5's backward on the CPU: the port's ``flash_attention`` op
(its forward's log-sum-exp and its backward op, ``attention_bwd_ref`` on
CPU tensors) against ``jax.grad`` of the JAX package's ``flash_attention``
(the Pallas forward in interpret mode, its custom VJP's ``_bwd``), on the
same inputs made from a seed with numpy, in float32 within 1e-5; the
log-sum-exp against float64 numpy; the backward op's fake implementation,
flop formula, layouts and routes; and the tf32x3 kernels' arithmetic,
backward and forward, emulated and held to the float32 limits.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import ops as r_fa_ops
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import kernel as p_fa_kernel
from repro_torch.kernels.flash_attention import ops as p_fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b, h, kh, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, skv, d)).astype(np.float32)
    w = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, w


def _jax_grads(q, k, v, w, causal):
    def loss(q, k, v):
        out = r_fa_ops.flash_attention(q, k, v, causal, 128, 128, True)
        return jnp.sum(out * jnp.asarray(w))
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# (B, H, KH, Sq, Skv, D, causal): GQA groups 2 and 4, causal and not,
# ragged Sq = Skv = 200, Sq 100 with Skv 77, Sq 64 with Skv 192, causal
# with Sq 300 > Skv 200 (where the reference op's forward pads wrongly,
# ROADMAP Queue 3; its _bwd differentiates attention_ref unpadded), and
# D 16, 64, 128 and 160
CASES = [
    (1, 4, 2, 72, 72, 16, True), (2, 8, 2, 64, 64, 16, False),
    (1, 4, 1, 96, 96, 16, True),
    (1, 2, 1, 200, 200, 16, True), (1, 2, 2, 200, 200, 16, False),
    (1, 2, 2, 100, 77, 16, False), (1, 2, 1, 64, 192, 16, True),
    (1, 2, 1, 64, 192, 16, False), (1, 2, 1, 300, 200, 16, True),
    (1, 2, 1, 130, 130, 64, True), (1, 4, 2, 100, 100, 128, False),
    (1, 2, 1, 130, 130, 160, True), (1, 4, 2, 100, 77, 160, False),
]


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal", CASES)
def test_backward_matches_jax_grad(b, h, kh, sq, skv, d, causal):
    """The op's gradients (CPU route: attention_bwd_ref from the forward's
    out and lse) and attention_bwd_ref called directly with the op's out
    and lse, both against jax.grad of the JAX package's op."""
    q, k, v, w = _inputs(sq * 1000 + skv + d, b, h, kh, sq, skv, d)
    want = _jax_grads(q, k, v, w, causal)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (p_fa_ops.flash_attention(*ts, causal) * torch.as_tensor(w)).sum() \
        .backward()
    for t, g in zip(ts, want):
        _close(t.grad, g, **TOL)
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    out, lse = p_fa_ops.flash_attention_fwd(qt, kt, vt, causal)
    direct = attention_bwd_ref(qt, kt, vt, out, lse, torch.as_tensor(w),
                               causal)
    for x, g, like in zip(direct, want, (q, k, v)):
        assert x.dtype == torch.float32 and x.shape == like.shape
        _close(x, g, **TOL)


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal", [
    (1, 4, 2, 72, 72, 16, True), (1, 2, 2, 100, 77, 16, False),
    (1, 2, 1, 300, 200, 16, True), (1, 2, 1, 64, 192, 16, True),
    (2, 4, 4, 50, 130, 160, False)])
def test_lse_matches_float64(b, h, kh, sq, skv, d, causal):
    """The forward's row log-sum-exp against numpy's in float64 over the
    scaled scores of the keys the top-left causal mask keeps."""
    q, k, _, _ = _inputs(sq + skv, b, h, kh, sq, skv, d)
    _, lse = p_fa_ops.flash_attention_fwd(
        *map(torch.as_tensor, (q, k, k)), causal)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    kg = np.repeat(k.astype(np.float64), h // kh, axis=1)
    s = np.einsum("bhid,bhjd->bhij", q.astype(np.float64), kg)
    s = s / math.sqrt(d)
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(skv)[None, :], s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = attention_lse_ref(*map(torch.as_tensor, (q, k, k)), causal)
    torch.testing.assert_close(plain, lse, rtol=0, atol=0)


def test_no_keys_gives_minus_inf_and_zero_gradients():
    """Skv = 0: every row keeps no key; lse is -inf, the output and the
    gradients are zero, nowhere NaN."""
    q = torch.randn(1, 2, 5, 8, requires_grad=True)
    k = torch.randn(1, 1, 0, 8, requires_grad=True)
    v = torch.randn(1, 1, 0, 8, requires_grad=True)
    out, lse = p_fa_ops.flash_attention_fwd(q, k, v, True)
    assert bool((lse == float("-inf")).all())
    assert bool((out == 0).all())
    (p_fa_ops.flash_attention(q, k, v, True) * 3.0).sum().backward()
    assert q.grad is not None and bool((q.grad == 0).all())
    assert k.grad.shape == k.shape and v.grad.shape == v.shape
    dq, dk, dv = attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   out, lse, torch.ones_like(out), True)
    assert bool((dq == 0).all()) and not bool(torch.isnan(dq).any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_fake_impl_shapes_and_strides(dtype):
    """On fake CUDA tensors (the dry run's), the backward op returns q's,
    k's and v's shapes, dtypes and strides ([B, S, H, D] views), and the
    forward a float32 [B, H, Sq] lse."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, h, kh, sq, skv, d = 2, 8, 2, 48, 40, 64
    with FakeTensorMode():
        q = torch.empty(b, sq, h, d, device="cuda",
                        dtype=dtype).transpose(1, 2)
        k = torch.empty(b, skv, kh, d, device="cuda",
                        dtype=dtype).transpose(1, 2)
        v = torch.empty(b, kh, skv, d, device="cuda", dtype=dtype)
        out, lse = p_fa_ops.flash_attention_fwd(q, k, v, True)
        grads = p_fa_ops.flash_attention_bwd(q, k, v, out, lse, out, True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert out.stride() == q.stride()
    for g, like in zip(grads, (q, k, v)):
        assert g.shape == like.shape and g.dtype == dtype
        assert g.stride() == like.stride() and g.device.type == "cuda"


@pytest.mark.parametrize("sq,skv,causal", [(48, 48, True), (48, 20, True),
                                           (20, 48, True), (48, 20, False)])
def test_forward_and_backward_flop_count(sq, skv, causal):
    """FlopCounterMode counts one forward and one backward at (4 + 10) B H
    D x the kept pairs: the function's two and five products, by the two
    ops' formulas."""
    from torch.utils.flop_counter import FlopCounterMode
    b, h, kh, d = 2, 4, 2, 16
    q = torch.randn(b, sq, h, d).transpose(1, 2).requires_grad_(True)
    k = torch.randn(b, kh, skv, d, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        p_fa_ops.flash_attention(q, k, k, causal).sum().backward()
    pairs = p_fa_ops.kept_pairs(sq, skv, causal)
    assert counter.get_total_flops() == 14 * b * h * d * pairs


def test_backward_variant_by_input():
    """The backward runs wgmma for bf16 at D 64, 128 and 160 (as the
    forward does) and tf32x3 for float32 and for bf16 at any other D
    (where the forward runs tf32x3 too); each backward variant has its own
    counter beside flash_attention_bwd."""
    for d in (64, 128, 160):
        assert p_fa_kernel.bwd_variant(torch.bfloat16, d) == "wgmma"
        assert p_fa_kernel.bwd_variant(torch.float32, d) == "tf32x3"
        assert p_fa_kernel.variant(torch.float32, d) == "tf32x3"
    for d in (1, 16, 32, 96, 200, 256):
        assert p_fa_kernel.bwd_variant(torch.bfloat16, d) == "tf32x3"
        assert p_fa_kernel.variant(torch.bfloat16, d) == "tf32x3"
    names = {c.name for c in (p_fa_kernel.BWD_LAUNCHES,
                              *p_fa_kernel.BWD_VARIANT_LAUNCHES.values())}
    assert names == {"flash_attention_bwd", "flash_attention_bwd_wgmma",
                     "flash_attention_bwd_tf32x3"}


def test_backward_routes_by_device():
    """CPU tensors take the plain backward and launch nothing; the kernel
    wrapper refuses CPU tensors; meta tensors take the op's fake
    implementation, which the route itself refuses."""
    x = torch.randn(1, 2, 8, 16)
    out, lse = p_fa_ops.flash_attention_fwd(x, x, x, True)
    reset_launch_counts()
    p_fa_ops.flash_attention_bwd(x, x, x, out, lse, out, True)
    assert all(n == 0 for name, n in launch_counts().items()
               if name.startswith("flash_attention"))
    with pytest.raises(ValueError):
        p_fa_kernel.flash_attention_bwd_kernel(x, x, x, out, lse, out)
    m = x.to("meta")
    grads = p_fa_ops.flash_attention_bwd(m, m, m, m, lse.to("meta"), m, True)
    assert all(g.device.type == "meta" and g.shape == x.shape for g in grads)
    with pytest.raises(ValueError):
        p_fa_ops._backward_op(m, m, m, m, lse.to("meta"), m, True)


@pytest.mark.parametrize("causal", [True, False])
def test_model_layout_and_expanded_gradient(causal):
    """The model's [B, S, H, D] layout gives the contiguous layout's
    gradients, laid out like their inputs; the stride-0 gradient of
    ``out.sum()`` gives what a dense gradient of ones gives."""
    q, k, v, _ = _inputs(5, 2, 4, 2, 70, 70, 16)
    bshd = [torch.tensor(x.transpose(0, 2, 1, 3), requires_grad=True)
            for x in (q, k, v)]
    p_fa_ops.flash_attention_bshd(*bshd, causal).sum().backward()
    bhsd = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = p_fa_ops.flash_attention(*bhsd, causal)
    dense = torch.autograd.grad(out, bhsd, torch.ones_like(out),
                                retain_graph=True)
    for a, c, g in zip(bshd, bhsd, dense):
        assert a.grad.stride() == a.stride()
        torch.testing.assert_close(a.grad.transpose(1, 2), g, **TOL)
    out.sum().backward()
    for c, g in zip(bhsd, dense):
        torch.testing.assert_close(c.grad, g, rtol=0, atol=0)


def test_remat_hands_the_recomputed_lse_to_the_backward():
    """Under torch.utils.checkpoint (the model's remat), the recomputed
    forward saves its own out and lse: the gradients equal the run
    without remat bit for bit, and each of the forward and backward ops
    runs as often as the recompute says (forward twice, backward once)."""
    from torch.utils.checkpoint import checkpoint
    q, k, v, w = _inputs(9, 1, 4, 2, 60, 60, 16)
    wt = torch.as_tensor(w)

    def block(q, k, v):
        return p_fa_ops.flash_attention(q * 1.5, k, v, True) * wt

    grads = []
    for remat in (False, True):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        y = checkpoint(block, *ts, use_reentrant=False) if remat else \
            block(*ts)
        y.sum().backward()
        grads.append([t.grad for t in ts])
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    with torch.profiler.profile() as prof:
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        checkpoint(block, *ts, use_reentrant=False).sum().backward()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith("repro_torch::")}
    assert calls == {"repro_torch::flash_attention_fwd": 2,
                     "repro_torch::flash_attention_bwd": 1}, calls


# ---------------------------------------------------------------------------
# The tf32x3 backward's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(
        torch.int32).view(torch.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 mantissa bits), nearest even, as the
    kernel rounds each operand's hi part (add 0xfff plus the kept lsb,
    clear the 13 low bits)."""
    u = _bits(x)
    return _float((u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 register handed to them as
    tf32: its top 19 bits (the mantissa truncated to 10 bits)."""
    return _float(_bits(x) & 0xFFFFE000)


def _split(x: torch.Tensor):
    """x = hi + lo as the kernels split it: hi = tf32(x), lo = x - hi as
    the tensor cores read it."""
    hi = _tf32(x)
    return hi, _tf32_read(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b with tf32 operands: one product (terms 1, both operands
    rounded), or the kernel's 3xTF32 split (terms 3: hi = tf32(x), lo = x
    - hi as the tensor cores read it; hi hi + hi lo + lo hi).  Each
    product of two tf32 values is exact in float32, so float32 matmuls of
    the parts model the tensor cores' products; the sums are float32, as
    the kernel's (it adds each step's products to its float32 sums
    itself), in another order."""
    if terms == 1:
        return _tf32(a) @ _tf32(b)
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32_bwd(q, k, v, out, lse, do, causal, terms):
    """The backward's equations as the tf32x3 kernel computes them (every
    product through :func:`_mm`; P and dS in float32; delta a float32
    sum), float32 [B, H, S, D] in and out."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    log2e = 1.4426950408889634
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = _mm(q, kk.transpose(-1, -2), terms)
    p = torch.exp2(s * (log2e / math.sqrt(d)) - (lse * log2e)[..., None])
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        p = torch.where(keep, p, 0.0)
    delta = (do * out).sum(-1, keepdim=True)
    ds = p * (_mm(do, vv.transpose(-1, -2), terms) - delta)
    dv = _mm(p.transpose(-1, -2), do, terms)
    dk = _mm(ds.transpose(-1, -2), q, terms) / math.sqrt(d)
    dq = _mm(ds, kk, terms) / math.sqrt(d)
    return (dq, dk.reshape(b, kh, g, skv, d).sum(2),
            dv.reshape(b, kh, g, skv, d).sum(2))


#: the float32 cases of tests/test_torch_cuda.py's backward test
#: (BWD_SHAPES and its two other head dims); its long (2, 12, 2, 2048,
#: 2048, 128) case, 2 x 12 x 2048^2 scores a product, is left to the card,
#: and [1, 512, 12/2, 128] causal stands for that training shape here
TF32X3_SHAPES = [(1, 2, 1, 200, 200, 64), (2, 4, 2, 333, 129, 64),
                 (1, 6, 1, 65, 1, 64), (1, 2, 1, 1, 300, 64),
                 (1, 8, 2, 300, 200, 128), (2, 4, 4, 128, 320, 128),
                 (1, 12, 2, 1000, 777, 128), (1, 4, 1, 257, 257, 128),
                 (2, 8, 2, 200, 200, 160), (1, 32, 8, 300, 300, 160),
                 (1, 6, 1, 333, 129, 160), (1, 2, 1, 1, 300, 160),
                 (2, 4, 2, 200, 300, 32), (1, 4, 1, 300, 200, 96)]


@pytest.mark.parametrize("shape,causal",
                         [(s, c) for s in TF32X3_SHAPES for c in (True, False)]
                         + [((1, 12, 2, 512, 512, 128), True)])
def test_tf32x3_arithmetic_holds_the_float32_limit(shape, causal):
    """The tf32x3 kernel's arithmetic, emulated (every product of the
    backward's equations in the 3xTF32 split), stays within the card
    tests' float32 limit, 1e-5 + 1e-5 |ref| an element, of
    attention_bwd_ref on the same inputs, out and lse; one tf32 product
    (the plain TF32 the kernel does not use) misses it, so the test tells
    the two apart."""
    b, h, kh, sq, skv, d = shape
    rng = np.random.default_rng(sq * skv + d + causal)
    q, k, v, g = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                  for s in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d),
                            (b, h, sq, d)))
    out = p_fa_ops.flash_attention_fwd(q, k, v, causal)[0]
    lse = attention_lse_ref(q, k, v, causal)
    want = attention_bwd_ref(q, k, v, out, lse, g, causal)

    def worst(terms):
        got = _tf32_bwd(q, k, v, out, lse, g, causal, terms)
        return max(float(((x - y).abs() / (1e-5 + 1e-5 * y.abs())).max())
                   for x, y in zip(got, want))

    assert worst(3) <= 1.0
    assert worst(1) > 1.0


def test_tf32_rounding_is_nearest_even():
    """The emulation's rounding: 10 mantissa bits kept, halves to even,
    exact values untouched; the tensor cores' read of a float32 register
    truncates."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, one + 3 * ulp / 2,
                      one + ulp / 2 + 2.0 ** -20, -(one + ulp / 4), 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one, one + 2 * ulp, one + ulp, -one, 0.0])
    assert torch.equal(_tf32(x), want)
    assert torch.equal(_tf32_read(x), torch.tensor(
        [one, one, one + ulp, one, -one, 0.0]))


# ---------------------------------------------------------------------------
# The tf32x3 forward's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         aligned: bool = False) -> torch.Tensor:
    """One k-step of the tensor cores, c + a @ b over 8 products of tf32
    values (exact in float64), summed as they sum: rounded toward zero to
    float32.  With ``aligned``, the harsher model of a unit that first
    aligns every term to the largest one, dropping the bits below its
    float32 ulp, then sums (costly: small shapes only)."""
    if not aligned:
        return _rz(c.double() + a.double() @ b.double())
    terms = torch.cat([a.double().unsqueeze(-1) * b.double().unsqueeze(-3),
                       c.double().unsqueeze(-2)], -2)
    top = terms.abs().amax(-2, keepdim=True)
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 24)
    return _rz((torch.trunc(terms / ulp) * ulp).sum(-2))


def _fwd_bucket(d: int) -> int:
    """D's bucket W, as tf32x3::bucket."""
    return next(w for w in (16, 32, 64, 96, 128, 160, 192, 256) if d <= w)


def _tf32_fwd(q, k, v, causal, terms=3, aligned=False):
    """The tf32x3 forward as the kernel computes it, float32 [B, H, S, D]
    in, (out, lse) out: D zero-padded to its bucket W; S = Q K^T by k-steps
    of 8 columns, each the three products al bh, ah bl (one sum) and ah bh
    (another) kept in the tensor cores' sums (:func:`_mma`), added once;
    the online softmax over tiles of the kernel's width (64 keys up to W
    64, 32 up to 128, 16 above) with masks at -1e30, p = 2^fma(s, c, -m c) (c = scale
    log2e in float32) flushed below 2^-126, the dead-row guard; each
    tile's P V from zero in the tensor cores over its k-steps of 8 keys,
    three products each (pl vh, ph vl, ph vh), then O = fma(O, corr, that
    sum) in float32;
    lse = (m c + log2 l) ln 2 and O / max(l, 1e-30).  ``terms`` 1: one
    tf32 product of rounded operands, summed the same way."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    w = _fwd_bucket(d)
    bk = 64 if w <= 64 else 32 if w <= 128 else 16
    pad = (0, w - d)
    qf = torch.nn.functional.pad(q.float(), pad)
    kf = torch.nn.functional.pad(k.float(), pad).repeat_interleave(h // kh, 1)
    vf = torch.nn.functional.pad(v.float(), pad).repeat_interleave(h // kh, 1)
    c = float(np.float32(np.float32(1.0 / math.sqrt(d)) *
                         np.float32(1.4426950408889634)))
    if terms == 3:
        (qh, ql), (kh_, kl) = _split(qf), _split(kf)
        steps = ((ql, kh_), (qh, kl))
    else:
        qh, kh_, steps = _tf32(qf), _tf32(kf), ()
    big = torch.zeros((b, h, sq, skv))
    small = torch.zeros((b, h, sq, skv))
    for lo in range(0, w, 8):
        sl = slice(lo, lo + 8)
        for a, bb in steps:
            small = _mma(small, a[..., sl], bb[..., sl].transpose(-1, -2),
                         aligned)
        big = _mma(big, qh[..., sl], kh_[..., sl].transpose(-1, -2), aligned)
    s_all = big + small
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, w))
    for k_lo in range(0, skv, bk):
        keys = torch.arange(k_lo, k_lo + bk)[None, :]
        s = torch.nn.functional.pad(s_all[..., k_lo:k_lo + bk],
                                    (0, max(0, k_lo + bk - skv)))
        vt = torch.nn.functional.pad(vf[:, :, k_lo:k_lo + bk],
                                     (0, 0, 0, max(0, k_lo + bk - skv)))
        masked = keys >= skv
        if causal:
            masked = masked | (keys > rows)
        s = s.masked_fill(masked, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        dead = m_new <= -1e30 / 2
        mc = torch.where(dead, 0.0, m_new * c)

        def exp2(x64):
            y = torch.exp2(x64.float())
            return torch.where(y < 2.0 ** -126, 0.0, y)

        p = torch.where(dead[..., None], 0.0,
                        exp2(s.double() * c - mc.double()[..., None]))
        corr = torch.where(dead, 1.0, exp2(m.double() * c - mc.double()))
        l = (l.double() * corr.double() + p.sum(-1).double()).float()
        if terms == 3:
            (ph, pl), (vh, vl) = _split(p), _split(vt)
        pv = torch.zeros_like(o)
        for kk in range(0, bk, 8):
            sl = slice(kk, kk + 8)
            parts = ([(_tf32(p), _tf32(vt))] if terms == 1 else
                     [(pl, vh), (ph, vl), (ph, vh)])
            for a, bb in parts:
                pv = _mma(pv, a[..., sl], bb[..., sl, :], aligned)
        o = (o.double() * corr.double()[..., None] + pv.double()).float()
        m = m_new
    out = o * (1.0 / l.clamp_min(1e-30))[..., None]
    lse = torch.where(m <= -1e30 / 2, float("-inf"),
                      ((m.double() * c + torch.log2(l).double()).float() *
                       math.log(2.0)))
    return out[..., :d], lse


def _fwd_float64(q, k, v, causal):
    """softmax(q k^T / sqrt(D)) v and its rows' log-sum-exp in float64."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    s = (q.double() @ k.double().repeat_interleave(g, 1).transpose(-1, -2)
         / math.sqrt(d))
    if causal:
        s = s.masked_fill(torch.arange(sq)[:, None] <
                          torch.arange(skv)[None, :], float("-inf"))
    return (torch.softmax(s, -1) @ v.double().repeat_interleave(g, 1),
            torch.logsumexp(s, -1))


def _worst(got, want) -> float:
    """The largest |got - want| over the float32 limit, 1e-5 + 1e-5
    |want|."""
    return float(((got.double() - want).abs() /
                  (1e-5 + 1e-5 * want.abs())).max())


#: the float32 cases of tests/test_torch_cuda.py's forward test (their
#: lengths and head dims; batch and heads cut, GQA kept), and its training
#: shape's float32 case, [1, 12/2, 512, 128], cut to 6 heads on 1
FWD_TF32X3_SHAPES = [
    (1, 1, 1, 128, 128, 32), (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 512, 16),
    (2, 4, 4, 200, 300, 24), (1, 2, 2, 384, 128, 128), (1, 2, 1, 70, 70, 256),
    (1, 2, 1, 300, 200, 16), (1, 6, 1, 333, 129, 64), (1, 6, 1, 333, 129, 128),
    (1, 6, 1, 65, 1, 64), (1, 6, 1, 65, 1, 160), (1, 2, 1, 1, 300, 64),
    (1, 2, 1, 1, 300, 160), (1, 6, 1, 257, 257, 64), (1, 2, 1, 1000, 777, 64),
    (1, 2, 1, 1000, 777, 128), (1, 2, 1, 1000, 777, 160),
    (1, 8, 2, 200, 200, 160), (1, 8, 2, 300, 300, 160),
    (1, 4, 4, 128, 320, 64), (1, 4, 1, 200, 150, 96), (1, 2, 1, 150, 200, 192),
    (1, 6, 1, 129, 33, 256), (2, 4, 2, 100, 90, 30), (1, 6, 1, 300, 17, 160),
    (1, 6, 1, 512, 512, 128)]


def _fwd_inputs(shape, causal):
    b, h, kh, sq, skv, d = shape
    rng = np.random.default_rng(sq * skv + d + causal)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d))]


@pytest.mark.parametrize("shape", FWD_TF32X3_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_forward_arithmetic_holds_the_float32_limit(shape, causal):
    """The tf32x3 forward's arithmetic, emulated (:func:`_tf32_fwd`),
    within the card tests' float32 limit, 1e-5 + 1e-5 |x| an element, of a
    float64 evaluation of the output and of each row's log-sum-exp."""
    q, k, v = _fwd_inputs(shape, causal)
    want, want_lse = _fwd_float64(q, k, v, causal)
    out, lse = _tf32_fwd(q, k, v, causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert _worst(out, want) <= 1.0
    assert _worst(lse, want_lse) <= 1.0


@pytest.mark.parametrize("shape", [(1, 2, 1, 200, 200, 64),
                                   (1, 2, 1, 1000, 777, 128),
                                   (1, 8, 2, 300, 300, 160)])
def test_one_tf32_product_breaks_the_forward_limit(shape):
    """The same arithmetic with one tf32 product (the plain TF32 the kernel
    does not use) misses the limit, so the test above tells the two
    apart."""
    q, k, v = _fwd_inputs(shape, True)
    want, _ = _fwd_float64(q, k, v, True)
    assert _worst(_tf32_fwd(q, k, v, True, terms=1)[0], want) > 1.0


@pytest.mark.parametrize("shape,causal", [((1, 2, 1, 70, 70, 256), True),
                                          ((1, 2, 1, 96, 80, 64), False),
                                          ((1, 2, 2, 40, 70, 160), True)])
def test_tf32x3_forward_holds_the_limit_with_aligned_sums(shape, causal):
    """Under the harsher model of the tensor cores' sums (every term
    aligned to the largest and cut below its ulp), S's sum kept in the
    tensor cores and each tile's P V from zero still hold the limit."""
    q, k, v = _fwd_inputs(shape, causal)
    want, want_lse = _fwd_float64(q, k, v, causal)
    out, lse = _tf32_fwd(q, k, v, causal, aligned=True)
    assert _worst(out, want) <= 1.0 and _worst(lse, want_lse) <= 1.0


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal", [
    (1, 4, 2, 72, 72, 16, True), (1, 2, 2, 100, 77, 24, False),
    (1, 2, 1, 130, 130, 64, True), (1, 4, 2, 100, 100, 128, False),
    (1, 2, 1, 130, 130, 160, True), (1, 2, 1, 64, 192, 96, True)])
def test_tf32x3_forward_matches_the_jax_op(b, h, kh, sq, skv, d, causal):
    """The emulated tf32x3 forward against the JAX package's op (its Pallas
    kernel in interpret mode) on the same inputs, within 1e-5 + 1e-5 |x|:
    the two float32 evaluations of one function."""
    q, k, v, _ = _inputs(sq + skv + d, b, h, kh, sq, skv, d)
    want = np.asarray(r_fa_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal, 128, 128, True))
    got, _ = _tf32_fwd(*map(torch.as_tensor, (q, k, v)), causal)
    _close(got, want, **TOL)


# ---------------------------------------------------------------------------
# The dK/dV pass's split (host side)
# ---------------------------------------------------------------------------
def test_dkv_splits_where_the_grid_is_short():
    """One block a KV tile fills less than a wave at qwen2-1.5b's training
    shape (4 x 2 KV heads x 16 tiles = 128 blocks on 132 SMs): split 2
    ways, the fewest that fill a wave (3 on a card of 300 SMs); a grid
    that fills the card (zamba2 32/32, pixtral 32/8 at D 160, granite
    16/8) stays whole; never more blocks a tile than its heaviest tile's
    steps."""
    splits = p_fa_kernel.dkv_splits
    assert splits(4, 2, 6, 2048, 2048, 128, 132) == 2
    assert splits(4, 2, 6, 2048, 2048, 128, 300) == 3
    assert splits(4, 32, 1, 2048, 2048, 64, 132) == 1
    assert splits(4, 8, 4, 2048, 2048, 160, 132) == 1
    assert splits(4, 8, 2, 2048, 2048, 64, 132) == 1
    assert splits(1, 1, 1, 64, 64, 64, 132) == 1
    assert splits(1, 1, 2, 130, 64, 16, 132) == 6
    assert splits(2, 2, 6, 2048, 2048, 128, 132) == 3
    assert p_fa_kernel.dkv_keys(128) == 128 and p_fa_kernel.dkv_keys(160) == 64


@pytest.mark.parametrize("b,kh,group,sq,skv,keys,rows,causal,splits", [
    (4, 2, 6, 2048, 2048, 128, 64, True, 3),
    (4, 2, 6, 2048, 2048, 128, 32, True, 3),
    (2, 1, 4, 333, 129, 128, 64, True, 5),
    (1, 2, 3, 300, 200, 64, 32, True, 7),
    (1, 2, 3, 100, 300, 64, 16, True, 2),
    (2, 2, 2, 200, 300, 128, 32, False, 4),
    (1, 3, 1, 64, 64, 128, 64, True, 1)])
def test_dkv_work_covers_each_kept_step_once_heaviest_first(
        b, kh, group, sq, skv, keys, rows, causal, splits):
    """Every kept (KV head, key tile, q head, q tile) is summed by exactly
    one block; the blocks of a key tile come in the tile order, heaviest
    tile first, and the shares of a tile's work differ by at most one
    step, the larger first."""
    from collections import Counter
    blocks = p_fa_kernel.dkv_work(b, kh, group, sq, skv, keys, rows, causal,
                                  splits)
    seen = Counter((blk["b"], blk["kv_head"], blk["key_tile"], h, qt)
                   for blk in blocks for h, qt in blk["steps"])
    n_q, n_kv = -(-sq // rows), -(-skv // keys)
    want = {(bb, kv, y, kv * group + j, qt)
            for bb in range(b) for kv in range(kh) for y in range(n_kv)
            for j in range(group) for qt in range(n_q)
            if not causal or qt * rows + rows - 1 >= y * keys}
    assert set(seen) == want and set(seen.values()) == {1}
    assert len(blocks) == splits * b * kh * n_kv
    tiles = [blk["key_tile"] for blk in blocks]
    assert tiles == sorted(tiles)
    work = {}
    for blk in blocks:
        work.setdefault(blk["key_tile"], []).append(len(blk["steps"]))
    totals = [sum(work[y]) for y in sorted(work)]
    assert totals == sorted(totals, reverse=True)
    for y, sizes in work.items():
        assert max(sizes) - min(sizes) <= 1
        for i in range(0, len(sizes), splits):
            share = sizes[i:i + splits]
            assert share == sorted(share, reverse=True)
    assert len(blocks[0]["steps"]) == max(len(blk["steps"]) for blk in blocks)
