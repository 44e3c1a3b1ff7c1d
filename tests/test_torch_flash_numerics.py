"""The error model of K5's bf16 tensor-core variant, emulated on the CPU.

``csrc/flash_attention.cu`` (namespace ``tc``) computes bf16 attention
with float32 scores, running max and sum, and an online softmax over
64-key tiles; the probabilities P enter the P V product on the tensor
cores as two bf16 operands, ``P_hi = bf16(p)`` and ``P_lo = bf16(p -
P_hi)``, and the output is rounded once to bf16.  The kernel's own check
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) holds it elementwise to
``|got - ref| <= 1e-4 + 2^-8 |ref|`` against float32 ``attention_ref``.

Why P is split: FlashAttention-2/3 round P once to bf16 before the P V
product.  At the main prefill shape ([1, 12, 2048, 128], kv heads 2,
causal, ``_inputs(0, ...)``) the emulation below puts 144,209 outputs
(4.6%) outside that limit with P rounded once — the outputs near zero,
where the error of rounding P does not scale with |out| — and none with
P split into hi + lo (max abs error 7.7e-3).

Here a test-local torch emulation of that arithmetic must pass the same
limit at small seeded inputs, and with P rounded once it must not (at
[1, 4, 256, 64], kv heads 2, causal: 7,837 of 65,536 outputs over the
limit).  It runs no kernel; the card's tests do.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_ref as r_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

NEG_INF = -1e30
BLOCK_KV = 64
RTOL, ATOL = 2.0 ** -8, 1e-4       # the kernel's bf16 limit


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def emulate_wgmma_flash(q, k, v, causal: bool, split_p: bool = True):
    """The tensor-core variant's arithmetic, tile by tile, in float32 on
    bf16-valued inputs: unscaled float32 scores, masks at -1e30 (keys
    past Skv always, keys above the row when causal), running max m,
    exp2 with scale * log2(e) folded in, the dead-row guard, float32 l
    and rescale, P V with P as bf16 hi + lo (or rounded once when
    ``split_p`` is False), output O / max(l, 1e-30) rounded to bf16."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    c = (1.0 / math.sqrt(d)) * math.log2(math.e)
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, d))
    for lo in range(0, skv, BLOCK_KV):
        keys = torch.arange(lo, lo + BLOCK_KV)[None, :]
        kt = torch.zeros((b, h, BLOCK_KV, d))
        vt = torch.zeros((b, h, BLOCK_KV, d))
        n = min(BLOCK_KV, skv - lo)
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, lo:lo + n], vf[:, :, lo:lo + n]
        s = qf @ kt.transpose(-1, -2)
        masked = keys >= skv
        if causal:
            masked = masked | (keys > rows)
        s = s.masked_fill(masked, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        dead = m_new <= NEG_INF / 2
        mc = torch.where(dead, 0.0, m_new * c)
        p = torch.where(dead[..., None], 0.0,
                        torch.exp2(s * c - mc[..., None]))
        corr = torch.where(dead, 1.0, torch.exp2(m * c - mc))
        l = l * corr + p.sum(-1)
        hi = _bf16(p)
        pv = hi @ vt
        if split_p:
            pv = pv + _bf16(p - hi) @ vt
        o = o * corr[..., None] + pv
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def _inputs(seed, b, h, kh, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d))]


@pytest.mark.parametrize("b,h,kh,sq,skv,d", [(1, 4, 2, 256, 256, 64),
                                             (1, 4, 1, 200, 150, 64),
                                             (1, 6, 1, 130, 300, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_emulation_holds_the_kernel_limit(b, h, kh, sq, skv, d,
                                                  causal):
    """Against float32 attention_ref of the port and of the JAX package,
    on the same bf16-valued inputs."""
    q, k, v = _inputs(sq * skv + d, b, h, kh, sq, skv, d)
    got = emulate_wgmma_flash(q, k, v, causal).float()
    assert torch.isfinite(got).all()
    refs = {"port": attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal),
            "jax": torch.as_tensor(np.array(r_attention(
                *(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                causal=causal)))}
    for name, want in refs.items():
        err = (got - want).abs()
        over = int((err > ATOL + RTOL * want.abs()).sum())
        assert over == 0, f"{over} outputs outside the bf16 limit against " \
                          f"{name}, max abs {float(err.max()):.3e}"


@pytest.mark.parametrize("causal", [True, False])
def test_p_rounded_once_breaks_the_kernel_limit(causal):
    """The reason for the split: the same arithmetic with P rounded once
    to bf16 (FlashAttention-2/3's) puts outputs outside the limit even at
    this small input, while the split passes it."""
    q, k, v = _inputs(7, 1, 4, 2, 256, 256, 64)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    limit = ATOL + RTOL * want.abs()
    over = {split: int(((emulate_wgmma_flash(q, k, v, causal, split)
                         .float() - want).abs() > limit).sum())
            for split in (True, False)}
    assert over[True] == 0 and over[False] > 0, over
