"""The Mamba2 SSD scan (Triton): the launch wrapper and its three kernels.

Replaces no Pallas kernel: the reference's scan is jitted XLA
(``repro/models/ssm.py:31``, ``chunked_linear_scan``), which the port ran
as plain torch (:func:`repro_torch.models.ssm.chunked_linear_scan`, still
the CPU's route and the mLSTM's).  That version wrote a float32 [chunk,
chunk] decay a head and chunk to device memory, copied the operands of
its einsums into layout, and passed the chunk states in a Python loop
over chunks.

Bound on the H100: bytes.  At Granite 4.0-H's widths (128 heads of 64,
N 128, one group, chunks of 256) the least time of a call is x, B and C
read and y written in bf16 and the log decays read in float32: 1.1 GB at
32,768 tokens, 0.33 ms at 3.35 TB/s.  Its ~2.1e11 FLOPs (C B^T once a
chunk) would take 0.21 ms at the bf16 tensor-core peak (the
benchmark's count, ``perfbench/yardstick/hybrid.py`` ``ssd_scan``).

Design: the SSD decomposition (arXiv:2405.21060, section 6), three
launches a call, each over a grid that fills the card at any length:

1. ``ssd_state_kernel``, a block a (chunk, tile of heads).  For each
   head it takes the cumulative sum of the chunk's log decays and keeps
   it ([b, h, s] float32) for the other two kernels.  It forms the
   chunk's state B^T (w x) [N, P] on the tensor cores, with
   w = exp(clamp(total - cumsum, -60, 0)) applied to x in float32 and
   rounded once to x's dtype.  (The plain version rounds w B instead.)
   The state is written in x's dtype, as the plain version's einsum
   writes it.
2. ``ssd_pass_kernel``, a block a (head, PASS_BLOCK state elements).  The
   state is carried from chunk to chunk in float32 registers.  Each
   chunk's starting state is written over that chunk's own state, in
   place, rounded to x's dtype as the plain version rounds it.  The final
   state is written in float32.
3. ``ssd_out_kernel``, a block a (chunk, ``rows`` rows, 2 heads).  It walks the rows' keys ``rows`` at a time up to their
   diagonal.  Each key block's C B^T is formed once for the block's heads
   (with one group, every head reads it), kept in x's dtype, as the
   plain version's einsum gives it, and masked to the causal pairs.
   Each head fuses its decay exp(clamp(cum_i - cum_j, -60, 0)) into it
   in float32, rounds it to x's dtype for its product with x, and sums
   into its own float32 accumulator; then it adds C h_prev times
   exp(cum_i), and y is rounded once.  No [chunk, chunk] tensor leaves
   the block.  A tile of 64 rows against all 256 keys, kept across a
   loop over heads, spilled registers (255 a thread) and ran 3x slower.

What bounds it as built: at 32,768 tokens the three take ~0.37, ~0.19
and ~1.08 ms against the call's 0.33 ms of bytes.  The output kernel
rereads each key block's B and x from L2 for every block of rows and
tile of heads, and computes a decay per head and causal pair; without
that elementwise work it still takes ~0.87 ms.

bf16 products run on the tensor cores (``tl.dot``) and sum in float32.
Float32 inputs take full float32 products (``input_precision="ieee"``).
Every decay is the plain version's exp(clamp(., -60, 0)) in float32, with
libdevice's expf, whatever x's dtype.  Nothing is summed with atomics, so two calls are bit-equal.  One call is
three launches, counted once on ``ssd_scan``, inside one
``chunked_linear_scan`` span.

The wrapper takes CUDA tensors only; :mod:`.ops` routes CPU tensors to
the plain version.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.kernels import build, counter

LAUNCHES = counter("ssd_scan")

#: what the kernel takes; any other CUDA input raises
DTYPES = (torch.bfloat16, torch.float32)
WIDTHS = (64, 128)          # the state size N and the head dim P
CHUNKS = (128, 256)

#: state elements a block of the state-passing kernel carries
PASS_BLOCK = 1024

#: tile sizes by x's dtype.  ``state_heads`` / ``out_heads``: heads a
#: block of the state / output kernel walks (their greatest common
#: divisor with the head count; the output kernel's 1 or 2); ``rows``:
#: chunk rows an output block computes, and keys a step of its loop;
#: ``bn``: state rows a product takes at once (0: all N); ``*_warps``,
#: ``*_stages``: Triton's launch options.  Float32 products run without
#: tensor cores and hold twice the bytes, so their tiles are smaller, to
#: fit shared memory.
TILES = {
    torch.bfloat16: dict(state_heads=8, state_warps=8, state_stages=1,
                         rows=64, out_heads=2, out_warps=4, out_stages=3,
                         bn=0),
    torch.float32: dict(state_heads=4, state_warps=4, state_stages=1,
                        rows=32, out_heads=2, out_warps=4, out_stages=1,
                        bn=32),
}

_KERNEL_NAMES = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")
#: the compiled kernels of the last launch, by name (registers, spills)
_LAST: Dict[str, object] = {}


@functools.lru_cache(maxsize=None)
def _kernels() -> Dict[str, object]:
    """Build the Triton kernels (first use only: importing this module
    must not need Triton).  Their bodies resolve ``tl`` and the helpers
    through this module's globals, which is where Triton looks them up."""
    build.use_triton_cache()
    import triton
    import triton.language as tl
    globals().update(tl=tl, _ld=build.triton_libdevice())

    @triton.jit
    def _mm(a, b, IEEE: tl.constexpr):
        if IEEE:
            out = tl.dot(a, b, input_precision="ieee")
        else:
            out = tl.dot(a, b)
        return out

    @triton.jit
    def _decay(x):
        # exp(clamp(x, -60, 0)) in float32, with libdevice's expf: the
        # CUDA math library's, which torch's exp calls too
        return _ld.exp(tl.minimum(tl.maximum(x, -60.0), 0.0))

    @triton.jit(do_not_specialize=["s", "nc"])
    def ssd_state_kernel(x_ptr, b_ptr, la_ptr, cum_ptr, st_ptr, s, nc, h,
                         sx_b, sx_s, sx_h, sb_b, sb_s, sl_b, sl_s, sl_h,
                         L: tl.constexpr, N: tl.constexpr, P: tl.constexpr,
                         BN: tl.constexpr, HEADS: tl.constexpr,
                         IEEE: tl.constexpr):
        # the tiles of heads of one chunk are neighbours in the grid, so
        # the chunk's B is read from L2 after the first
        pid = tl.program_id(0)
        tiles = h // HEADS
        h_lo = pid % tiles * HEADS
        bi = (pid // tiles // nc).to(tl.int64)
        c = pid // tiles % nc
        i = tl.arange(0, L)
        t = (c * L + i).to(tl.int64)
        live = t < s
        pcol = tl.arange(0, P)
        ncol = tl.arange(0, BN)
        if BN == N:
            # B^T of the chunk, read once for the tile of heads
            bt = tl.load(b_ptr + bi * sb_b + t[None, :] * sb_s +
                         ncol[:, None], mask=live[None, :], other=0.0)
        for hh in range(HEADS):
            head = h_lo + hh
            la = tl.load(la_ptr + bi * sl_b + t * sl_s + head * sl_h,
                         mask=live, other=0.0)
            cum = tl.cumsum(la, axis=0)
            tl.store(cum_ptr + (bi * h + head) * nc * L + c * L + i, cum)
            total = tl.sum(tl.where(i == L - 1, cum, 0.0), axis=0)
            xt = tl.load(x_ptr + bi * sx_b + t[:, None] * sx_s +
                         head * sx_h + pcol[None, :], mask=live[:, None],
                         other=0.0)
            xs = (xt.to(tl.float32) *
                  _decay(total - cum)[:, None]).to(xt.dtype)
            out = st_ptr + ((bi * nc + c) * h + head) * (N * P)
            if BN == N:
                st = _mm(bt, xs, IEEE)
                tl.store(out + ncol[:, None] * P + pcol[None, :],
                         st.to(xt.dtype))
            else:
                for n0 in tl.static_range(0, N, BN):
                    btn = tl.load(b_ptr + bi * sb_b + t[None, :] * sb_s +
                                  (n0 + ncol)[:, None], mask=live[None, :],
                                  other=0.0)
                    st = _mm(btn, xs, IEEE)
                    tl.store(out + (n0 + ncol)[:, None] * P + pcol[None, :],
                             st.to(xt.dtype))

    @triton.jit(do_not_specialize=["nc", "h"])
    def ssd_pass_kernel(st_ptr, cum_ptr, h0_ptr, fin_ptr, nc, h,
                        L: tl.constexpr, NP: tl.constexpr,
                        BLOCK: tl.constexpr, HAS_H0: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)            # batch x h + head
        bi = pid // h
        head = pid % h
        offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        if HAS_H0:
            hc = tl.load(h0_ptr + pid * NP + offs)
        else:
            hc = tl.zeros([BLOCK], dtype=tl.float32)
        row = st_ptr + (bi * nc * h + head) * NP + offs
        step = h.to(tl.int64) * NP
        tot = cum_ptr + pid * nc * L + (L - 1)
        nxt = tl.load(row)
        for c in range(nc):
            cur = nxt
            # the next chunk's state is read before this one's is
            # overwritten with its starting state
            nxt = tl.load(row + (c + 1) * step,
                          mask=(offs * 0 + c + 1) < nc, other=0.0)
            tl.store(row + c * step, hc.to(cur.dtype))
            hc = _decay(tl.load(tot + c * L)) * hc + \
                cur.to(tl.float32)
        tl.store(fin_ptr + pid * NP + offs, hc)

    @triton.jit
    def _cbt(c_ptr, b_ptr, cm, bi, ti, tj, live_i, live_j, sc_b, sc_s, sb_b,
             sb_s, N: tl.constexpr, BN: tl.constexpr, BM: tl.constexpr,
             IEEE: tl.constexpr):
        # C B^T of the rows ti and the keys tj, rounded to x's dtype as
        # the plain version's einsum gives it; ``cm``: the rows' C when
        # BN == N, read here a piece of BN state columns at a time else
        ncol = tl.arange(0, BN)
        if BN == N:
            bk = tl.load(b_ptr + bi * sb_b + tj[None, :] * sb_s +
                         ncol[:, None], mask=live_j[None, :], other=0.0)
            g = _mm(cm, bk, IEEE)
        else:
            g = tl.zeros([BM, BM], dtype=tl.float32)
            for n0 in tl.static_range(0, N, BN):
                cmn = tl.load(c_ptr + bi * sc_b + ti[:, None] * sc_s +
                              (n0 + ncol)[None, :], mask=live_i[:, None],
                              other=0.0)
                bkn = tl.load(b_ptr + bi * sb_b + tj[None, :] * sb_s +
                              (n0 + ncol)[:, None], mask=live_j[None, :],
                              other=0.0)
                g += _mm(cmn, bkn, IEEE)
        return g.to(c_ptr.dtype.element_ty)

    @triton.jit
    def _intra(acc, g, cum_i, crow, xrow, j, tj, live_j, sx_s, pcol,
               IEEE: tl.constexpr):
        # one head's share of a key block: acc + (g o decay) x, g masked
        cum_j = tl.load(crow + j)
        xk = tl.load(xrow + tj[:, None] * sx_s + pcol[None, :],
                     mask=live_j[:, None], other=0.0)
        mt = g.to(tl.float32) * _decay(cum_i[:, None] - cum_j[None, :])
        return acc + _mm(mt.to(xk.dtype), xk, IEEE)

    @triton.jit
    def _inter_store(acc, cm, cum_i, hp, yrow, c_ptr, bi, ti, live_i, sc_b,
                     sc_s, sy_s, pcol, N: tl.constexpr, P: tl.constexpr,
                     BN: tl.constexpr, BM: tl.constexpr, IEEE: tl.constexpr):
        # one head's rows: acc + exp(cum_i) C h_prev, stored in y's dtype
        ncol = tl.arange(0, BN)
        if BN == N:
            inter = _mm(cm, tl.load(hp + ncol[:, None] * P + pcol[None, :]),
                        IEEE)
        else:
            inter = tl.zeros([BM, P], dtype=tl.float32)
            for n0 in tl.static_range(0, N, BN):
                cmn = tl.load(c_ptr + bi * sc_b + ti[:, None] * sc_s +
                              (n0 + ncol)[None, :], mask=live_i[:, None],
                              other=0.0)
                inter += _mm(cmn, tl.load(hp + (n0 + ncol)[:, None] * P +
                                          pcol[None, :]), IEEE)
        acc += inter * _decay(cum_i)[:, None]
        tl.store(yrow + ti[:, None] * sy_s + pcol[None, :],
                 acc.to(yrow.dtype.element_ty), mask=live_i[:, None])

    @triton.jit(do_not_specialize=["s", "nc"])
    def ssd_out_kernel(x_ptr, b_ptr, c_ptr, cum_ptr, st_ptr, y_ptr, s, nc, h,
                       sx_b, sx_s, sx_h, sb_b, sb_s, sc_b, sc_s,
                       sy_b, sy_s, sy_h,
                       L: tl.constexpr, N: tl.constexpr, P: tl.constexpr,
                       BM: tl.constexpr, BN: tl.constexpr,
                       HEADS: tl.constexpr, IEEE: tl.constexpr):
        # rows m BM.. of chunk c for heads h0..h0+HEADS-1 (HEADS 1 or 2):
        # their keys a block of BM at a time up to the diagonal, each
        # block's C B^T formed once for the heads, one accumulator a head
        # the tiles of heads of one row block, then the row blocks of one
        # chunk, are neighbours in the grid, so the chunk's B and C and
        # each head's x are read from L2 after the first
        pid = tl.program_id(0)
        tiles = h // HEADS
        h0 = pid % tiles * HEADS
        rest = pid // tiles
        m = L // BM - 1 - rest % (L // BM)     # the longest rows first
        rest = rest // (L // BM)
        c = rest % nc
        bi = (rest // nc).to(tl.int64)
        i = m * BM + tl.arange(0, BM)
        ti = (c * L + i).to(tl.int64)
        live_i = ti < s
        r = tl.arange(0, BM)
        pcol = tl.arange(0, P)
        ncol = tl.arange(0, BN)
        hstep = nc * L
        crow = cum_ptr + (bi * h + h0) * hstep + c * L
        xrow = x_ptr + bi * sx_b + h0 * sx_h
        if BN == N:
            cm = tl.load(c_ptr + bi * sc_b + ti[:, None] * sc_s +
                         ncol[None, :], mask=live_i[:, None], other=0.0)
        else:
            cm = 0
        cum_i0 = tl.load(crow + i)
        acc0 = tl.zeros([BM, P], dtype=tl.float32)
        if HEADS > 1:
            cum_i1 = tl.load(crow + hstep + i)
            acc1 = tl.zeros([BM, P], dtype=tl.float32)
        for kb in range(0, m + 1):
            j = kb * BM + r
            tj = (c * L + j).to(tl.int64)
            live_j = tj < s
            g = _cbt(c_ptr, b_ptr, cm, bi, ti, tj, live_i, live_j, sc_b,
                     sc_s, sb_b, sb_s, N, BN, BM, IEEE)
            # the causal mask, once for the heads: a masked entry's decay,
            # exp(clamp(cum_i - cum_j > 0)) = 1, leaves it 0
            g = tl.where(i[:, None] >= j[None, :], g, 0.0)
            acc0 = _intra(acc0, g, cum_i0, crow, xrow, j, tj,
                          live_j, sx_s, pcol, IEEE)
            if HEADS > 1:
                acc1 = _intra(acc1, g, cum_i1, crow + hstep,
                              xrow + sx_h, j, tj, live_j, sx_s, pcol, IEEE)
        hp = st_ptr + ((bi * nc + c) * h + h0) * (N * P)
        yrow = y_ptr + bi * sy_b + h0 * sy_h
        _inter_store(acc0, cm, cum_i0, hp, yrow, c_ptr, bi, ti, live_i,
                     sc_b, sc_s, sy_s, pcol, N, P, BN, BM, IEEE)
        if HEADS > 1:
            _inter_store(acc1, cm, cum_i1, hp + N * P, yrow + sy_h, c_ptr,
                         bi, ti, live_i, sc_b, sc_s, sy_s, pcol, N, P, BN,
                         BM, IEEE)

    globals().update(_mm=_mm, _decay=_decay, _cbt=_cbt, _intra=_intra,
                     _inter_store=_inter_store)
    return {"state": ssd_state_kernel, "pass": ssd_pass_kernel,
            "out": ssd_out_kernel}


def _check(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
           loga: torch.Tensor, chunk: int, h0: Optional[torch.Tensor]
           ) -> None:
    """Raise on what the kernel does not take (device, dtype, shape,
    layout)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("the ssd_scan kernel takes CUDA tensors")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan: x must be bfloat16 or float32, got "
                         f"{x.dtype}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_scan: x must be [b, s, h, p] and B, C "
                         f"[b, s, g, n], got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    want = ((B, x.dtype, (b, s, g, n), "B"), (C, x.dtype, (b, s, g, n), "C"),
            (loga, torch.float32, (b, s, h), "loga"))
    if h0 is not None:
        want += ((h0, torch.float32, (b, h, n, p), "h0"),)
    for t, dtype, shape, name in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} must be a {dtype} tensor of "
                             f"shape {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if g != 1:
        raise ValueError(f"ssd_scan takes one group of B and C, got {g}")
    if n not in WIDTHS or p not in WIDTHS or chunk not in CHUNKS:
        raise ValueError(f"ssd_scan takes N and P in {WIDTHS} and chunks "
                         f"in {CHUNKS}, got N {n}, P {p}, chunk {chunk}")
    if s < 1:
        raise ValueError("ssd_scan: the sequence is empty")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd_scan: x, B and C must have unit stride in "
                         "their last dimension")


def ssd_scan_kernel(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    loga: torch.Tensor, chunk: int,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [b, s, h, p] in x's dtype, the final state [b, h, n, p] in
    float32) for x [b, s, h, p] (dt-scaled), B and C [b, s, 1, n] in x's
    dtype, ``loga`` [b, s, h] float32, chunks of ``chunk`` and the
    starting state ``h0`` [b, h, n, p] float32 (zeros when None): the
    plain version's numbers (``models.ssm.chunked_linear_scan``), each
    product's sum kept in float32."""
    _check(x, B, C, loga, chunk, h0)
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    tiles = TILES[x.dtype]
    bn = tiles["bn"] or n
    ieee = x.dtype == torch.float32
    dev = x.device
    k = _kernels()
    with tracing.span("chunked_linear_scan"):
        cum = torch.empty((b, h, nc * chunk), dtype=torch.float32,
                          device=dev)
        states = torch.empty((b, nc, h, n, p), dtype=x.dtype, device=dev)
        y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
        final = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
        heads = math.gcd(h, tiles["state_heads"])
        _LAST["ssd_state_kernel"] = k["state"][(b * nc * (h // heads),)](
            x, B, loga, cum, states, s, nc, h, *x.stride()[:3],
            *B.stride()[:2], *loga.stride(), L=chunk, N=n, P=p, BN=bn,
            HEADS=heads, IEEE=ieee, num_warps=tiles["state_warps"],
            num_stages=tiles["state_stages"])
        _LAST["ssd_pass_kernel"] = k["pass"][(b * h, n * p // PASS_BLOCK)](
            states, cum, final if h0 is None else h0.contiguous(), final, nc,
            h, L=chunk, NP=n * p, BLOCK=PASS_BLOCK, HAS_H0=h0 is not None,
            num_warps=4)
        heads = math.gcd(h, tiles["out_heads"])
        rows = tiles["rows"]
        _LAST["ssd_out_kernel"] = k["out"][
            (b * nc * (chunk // rows) * (h // heads),)](
            x, B, C, cum, states, y, s, nc, h, *x.stride()[:3],
            *B.stride()[:2], *C.stride()[:2], *y.stride()[:3], L=chunk,
            N=n, P=p, BM=rows, BN=bn, HEADS=heads, IEEE=ieee,
            num_warps=tiles["out_warps"], num_stages=tiles["out_stages"])
    LAUNCHES.hit()
    return y, final


def kernel_info() -> Dict[str, Dict[str, object]]:
    """Registers, spills and shared memory of each kernel as last
    launched (empty before the first launch)."""
    out = {}
    for name in _KERNEL_NAMES:
        compiled = _LAST.get(name)
        if compiled is None:
            continue
        meta = getattr(compiled, "metadata", None)
        out[name] = {"registers": getattr(compiled, "n_regs", None),
                     "spills": getattr(compiled, "n_spills", None),
                     "shared_bytes": getattr(meta, "shared", None)}
    return out
