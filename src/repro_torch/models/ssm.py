"""State-space and recurrent blocks: Mamba2 (chunked SSD), mLSTM, sLSTM
(the port of ``repro/models/ssm.py``).

The reference runs these as jitted XLA with no Pallas kernel, so the port
runs them as plain torch: ``lax.scan`` becomes a Python loop (over chunk
states in :func:`chunked_linear_scan`, over time in the sLSTM).  Dtype
casts mirror the reference's: decays and chunk states in float32, the
intra-chunk matrix formed in float32 and cast to the input's dtype.  One
exception: a Mamba2 mixer that autograd does not record (serving) takes
its scan from the ``ssd_scan`` op (``kernels/ssd_scan``), which runs the
kernel on CUDA tensors, keeping those casts or more precision, and
:func:`chunked_linear_scan` on the CPU; a recorded forward and the mLSTM
call :func:`chunked_linear_scan` themselves.
The scans carry spans (``chunked_linear_scan``, one a call on either
route, and ``slstm_scan``; see ``repro_torch/tracing.py``) so a trace can
read their device time, and so does each Mamba2 mixer (``mamba2``, from
``in_proj`` to ``out_proj``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import runtime, tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import records_grad
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import normal, rmsnorm
from repro_torch.parallel import ctx

Params = Dict[str, Any]


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


# ---------------------------------------------------------------------------
# Shared chunked linear-recurrence scan:
#   h_t = exp(loga_t) h_{t-1} + B_t (x_t)^T ;  y_t = C_t . h_t
# shapes: x [b,s,h,p], B/C [b,s,g,n] (g groups of h/g heads each: g = h
# for per-head B and C, 1 for Mamba2's one group), loga [b,s,h]
# ---------------------------------------------------------------------------
#: elements of the per-head [chunk, chunk] decay and matrix the scan holds
#: at once: the intra-chunk part and the chunk states take the chunks this
#: many elements at a time (a 32k-token Mamba2 prompt with 128 heads and
#: chunks of 256 would need 4.3 GB a float32 tensor in one piece)
SCAN_BLOCK_ELEMENTS = 1 << 27


def chunked_linear_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                        loga: torch.Tensor, chunk: int,
                        h0: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [b,s,h,p] in x's dtype, the final state [b,h,n,p] in
    float32).  Head ``i`` reads group ``i // (h / g)`` of B and C, whose
    product C B^T within a chunk is formed once a group."""
    with tracing.span("chunked_linear_scan"):
        b, s, h, p = x.shape
        g, n = B.shape[-2:]
        hg = h // g
        chunk = min(chunk, s)
        s_pad = -(-s // chunk) * chunk
        if s_pad != s:  # pad to a chunk multiple (masked by zero decay-in)
            pad = s_pad - s
            x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
            loga = F.pad(loga, (0, 0, 0, pad))
        nc = s_pad // chunk
        xc = x.reshape(b, nc, chunk, h, p)
        Bc = B.reshape(b, nc, chunk, g, n)
        Cc = C.reshape(b, nc, chunk, g, n)
        la = loga.reshape(b, nc, chunk, h).to(torch.float32)

        cum = torch.cumsum(la, dim=2)                       # [b,nc,cl,h]
        total = cum[:, :, -1]                               # [b,nc,h]
        ii = torch.arange(chunk, device=x.device)
        causal = ii[:, None] >= ii[None, :]
        cum_t = cum.permute(0, 1, 3, 2)                     # [b,nc,h,cl]
        w_out = _clip_exp(total[:, :, None, :] - cum)       # [b,nc,cl,h]

        # --- intra-chunk (quadratic within the chunk, like attention) and
        # the chunk states, a block of chunks at a time -------------------
        step = max(1, SCAN_BLOCK_ELEMENTS // (b * h * chunk * chunk))
        y_intra, states = [], []
        for c0 in range(0, nc, step):
            k = slice(c0, c0 + step)
            nk = min(step, nc - c0)
            G = torch.einsum("bcign,bcjgn->bcgij", Cc[:, k], Bc[:, k])
            decay = _clip_exp(cum_t[:, k, :, :, None] -
                              cum_t[:, k, :, None, :])  # [b,nk,h,cl,cl]
            M = (G.to(torch.float32)[:, :, :, None] *
                 decay.view(b, nk, g, hg, chunk, chunk) * causal
                 ).to(x.dtype).reshape(b, nk, h, chunk, chunk)
            y_intra.append(torch.einsum("bchij,bcjhp->bcihp", M, xc[:, k]))
            wB = (w_out[:, k].to(x.dtype).view(b, nk, chunk, g, hg, 1) *
                  Bc[:, k, :, :, None]).reshape(b, nk, chunk, h, n)
            states.append(torch.einsum("bcjhn,bcjhp->bchnp", wB, xc[:, k]))
        y_intra = torch.cat(y_intra, dim=1)
        states = torch.cat(states, dim=1)                   # [b,nc,h,n,p]

        # --- inter-chunk recurrence over nc --------------------------------
        hc = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
              if h0 is None else h0)
        decay_c = _clip_exp(total)[..., None, None]         # [b,nc,h,1,1]
        h_prevs = []
        for c in range(nc):
            h_prevs.append(hc)
            hc = decay_c[:, c] * hc + states[:, c].to(torch.float32)
        h_prevs = torch.stack(h_prevs, dim=1)               # [b,nc,h,n,p]

        # --- inter-chunk contribution --------------------------------------
        w_in = _clip_exp(cum)
        y_inter = torch.einsum(
            "bcign,bcgknp->bcigkp", Cc,
            h_prevs.to(x.dtype).view(b, nc, g, hg, n, p)).reshape(
                b, nc, chunk, h, p) * w_in.to(x.dtype)[..., None]
        y = (y_intra + y_inter).reshape(b, s_pad, h, p)[:, :s]
        return y, hc


def mamba2_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                loga: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's scan, :func:`chunked_linear_scan`'s contract: the
    ``ssd_scan`` op where autograd does not record (serving; the kernel on
    CUDA tensors), else the plain version, which autograd can record."""
    if not records_grad(x, B, C, loga):
        return ssd_scan(x, B, C, loga, chunk)
    return chunked_linear_scan(x, B, C, loga, chunk)


def linear_scan_step(h: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, loga: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. h [b,hh,n,p]; x [b,hh,p]; B/C [b,hh,n]; loga [b,hh]."""
    decay = _clip_exp(loga)[..., None, None]
    h = decay * h.to(torch.float32) + torch.einsum(
        "bhn,bhp->bhnp", B, x).to(torch.float32)
    y = torch.einsum("bhn,bhnp->bhp", C.to(torch.float32), h)
    return h, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def mamba2_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, head dim, heads, state size N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    headdim = cfg.ssm_head_dim
    n_heads = d_in // headdim
    return d_in, headdim, n_heads, cfg.ssm_state


CONV_WIDTH = 4


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, device=None
                ) -> Params:
    d = cfg.d_model
    d_in, hd, h, n = mamba2_dims(cfg)
    conv_dim = d_in + 2 * n
    scale = 1.0 / math.sqrt(d)
    dt = cfg.pdtype()
    f32 = torch.float32
    return {
        # projections to z (gate), x, B, C, dt
        "in_proj": normal(gen, (d, 2 * d_in + 2 * n + h), scale, dt, device),
        "conv_w": normal(gen, (CONV_WIDTH, conv_dim), 0.1, dt, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.zeros((h,), dtype=f32, device=device),
        "D_skip": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "norm_scale": torch.ones((d_in,), dtype=dt, device=device),
        "out_proj": normal(gen, (d_in, d),
                           1.0 / math.sqrt(2 * d_in * cfg.n_layers), dt,
                           device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x [b,s,c]; w [W,c]; state [b,W-1,c]."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i][None, None] for i in range(width))
    new_state = xp[:, -(width - 1):]
    return F.silu(out + b[None, None]), new_state


def _mamba2_project(params: Params, x: torch.Tensor, cfg: ArchConfig):
    d_in, hd, h, n = mamba2_dims(cfg)
    proj = ctx.einsum("bsd,de->bse", x,
                      params["in_proj"].to(cfg.cdtype()))
    z, xin, Bv, Cv, dt = torch.split(proj, [d_in, d_in, n, n, h], dim=-1)
    return ctx.constrain_ffn(z), ctx.constrain_ffn(xin), Bv, Cv, dt


def _mamba2_dt(params: Params, dt: torch.Tensor):
    """(dt after softplus, log decay), both float32."""
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    return dt, dt * -torch.exp(params["A_log"])


#: the Mamba2 parameters its token mixing (conv, scan, gate, norm) reads
MIX_WEIGHTS = ("conv_w", "conv_b", "dt_bias", "A_log", "D_skip",
               "norm_scale")


def _mamba2_mix(cfg: ArchConfig, z, xin, Bv, Cv, dt, *weights):
    """The conv, the chunked scan, the skip, the gate and the norm over
    the projections [b, s, .]: (the gated, normed [b, s, d_in], the scan's
    final state [b, h, N, hd] in float32, the conv's last inputs [b, W-1,
    d_in + 2N])."""
    params = dict(zip(MIX_WEIGHTS, weights))
    b, s, _ = xin.shape
    d_in, hd, h, n = mamba2_dims(cfg)
    dtype = cfg.cdtype()
    conv_out, conv_state = _causal_conv(torch.cat([xin, Bv, Cv], dim=-1),
                                        params["conv_w"].to(dtype),
                                        params["conv_b"].to(dtype))
    xin, Bv, Cv = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt, loga = _mamba2_dt(params, dt)                       # [b,s,h]
    xh = xin.reshape(b, s, h, hd) * dt[..., None].to(dtype)
    # one group: every head reads the same B and C
    y, h_state = mamba2_scan(xh, Bv[:, :, None, :].to(dtype),
                             Cv[:, :, None, :].to(dtype), loga, cfg.ssm_chunk)
    y = y + params["D_skip"][None, None, :, None].to(dtype) * \
        xin.reshape(b, s, h, hd)
    y = y.reshape(b, s, d_in) * F.silu(z)
    return (rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps),
            h_state, conv_state)


def mamba2_prefill(params: Params, x: torch.Tensor, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, Params]:
    """The mixer over a prompt x [b, s, d] in one pass: (its output, the
    decode state after the prompt, as :func:`mamba2_step` takes it: the
    scan's final state ``h`` and the conv's last inputs ``conv``).  A
    ``mamba2`` span.  The projections and ``out_proj`` split as the rules
    place their weights; the token mixing on each rank's shard of the
    batch."""
    with tracing.span("mamba2"):
        y, h_state, conv_state = ctx.batch_local(
            functools.partial(_mamba2_mix, cfg),
            _mamba2_project(params, x, cfg),
            [params[k] for k in MIX_WEIGHTS], n_out=3)
        out = ctx.einsum("bse,ed->bsd", y,
                         params["out_proj"].to(cfg.cdtype()))
    return out, {"h": h_state, "conv": conv_state}


def mamba2_forward(params: Params, x: torch.Tensor, cfg: ArchConfig
                   ) -> torch.Tensor:
    """:func:`mamba2_prefill`'s output, its state left."""
    return mamba2_prefill(params, x, cfg)[0]


def mamba2_init_state(cfg: ArchConfig, batch: int, device=None) -> Params:
    d_in, hd, h, n = mamba2_dims(cfg)
    dev = runtime.device(device)
    return {"h": torch.zeros((batch, h, n, hd), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, d_in + 2 * n),
                                dtype=cfg.cdtype(), device=dev)}


def _mamba2_step_mix(cfg: ArchConfig, z, xin, Bv, Cv, dt, h_state,
                     conv_state, *weights):
    """One token's conv, scan step, skip, gate and norm: (y [b, 1,
    d_in], the new scan state, the new conv state)."""
    params = dict(zip(MIX_WEIGHTS, weights))
    b = xin.shape[0]
    d_in, hd, h, n = mamba2_dims(cfg)
    dtype = cfg.cdtype()
    conv_out, conv_state = _causal_conv(
        torch.cat([xin, Bv, Cv], dim=-1), params["conv_w"].to(dtype),
        params["conv_b"].to(dtype), conv_state)
    xin, Bv, Cv = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt, loga = _mamba2_dt(params, dt[:, 0])                 # [b,h]
    xh = xin[:, 0].reshape(b, h, hd) * dt[..., None].to(dtype)
    Bh = Bv[:, 0, None, :].expand(b, h, n).to(dtype)
    Ch = Cv[:, 0, None, :].expand(b, h, n).to(dtype)
    h_new, y = linear_scan_step(h_state, xh, Bh, Ch, loga)
    y = y + params["D_skip"][None, :, None].to(dtype) * \
        xin[:, 0].reshape(b, h, hd)
    y = y.reshape(b, 1, d_in) * F.silu(z)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    return y, h_new, conv_state


def mamba2_step(params: Params, x: torch.Tensor, state: Params,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x [b,1,d].  A ``mamba2`` span."""
    with tracing.span("mamba2"):
        y, h_new, conv_state = ctx.batch_local(
            functools.partial(_mamba2_step_mix, cfg),
            (*_mamba2_project(params, x, cfg), state["h"], state["conv"]),
            [params[k] for k in MIX_WEIGHTS], n_out=3)
        out = ctx.einsum("bse,ed->bsd", y,
                         params["out_proj"].to(cfg.cdtype()))
    return out, {"h": h_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory C += i v k^T with forget decay
# ---------------------------------------------------------------------------
def xlstm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    return d_in, h, d_in // h


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    d = cfg.d_model
    d_in, h, hd = xlstm_dims(cfg)
    scale = 1.0 / math.sqrt(d)
    s_in = 1 / math.sqrt(d_in)
    dt, f32 = cfg.pdtype(), torch.float32
    return {
        "up_proj": normal(gen, (d, 2 * d_in), scale, dt, device),
        "wq": normal(gen, (d_in, h, hd), s_in, dt, device),
        "wk": normal(gen, (d_in, h, hd), s_in, dt, device),
        "wv": normal(gen, (d_in, h, hd), s_in, dt, device),
        "w_igate": normal(gen, (d_in, h), s_in, f32, device),
        "w_fgate": normal(gen, (d_in, h), s_in, f32, device),
        "fgate_bias": torch.full((h,), 3.0, dtype=f32, device=device),
        "norm_scale": torch.ones((d_in,), dtype=dt, device=device),
        "down_proj": normal(gen, (d_in, d),
                            1 / math.sqrt(2 * d_in * cfg.n_layers), dt,
                            device),
    }


def _mlstm_gates(xu: torch.Tensor, w_fgate: torch.Tensor,
                 w_igate: torch.Tensor, fgate_bias: torch.Tensor):
    """Stabilized gating: sigmoid forget in log space, exp input gate folded
    into the key scaling (chunk-stable simplification of xLSTM eq. 19-27)."""
    xf = xu.to(torch.float32)
    logf = F.logsigmoid(xf @ w_fgate + fgate_bias)
    igate = torch.sigmoid(xf @ w_igate)
    return logf, igate                                      # [b,s,h]


def _mlstm_qkv(params: Params, x: torch.Tensor, cfg: ArchConfig):
    d_in, h, hd = xlstm_dims(cfg)
    dtype = cfg.cdtype()
    up = ctx.einsum("bsd,de->bse", x, params["up_proj"].to(dtype))
    xu, z = torch.chunk(up, 2, dim=-1)
    q = ctx.einsum("bse,ehk->bshk", xu, params["wq"].to(dtype))
    k = ctx.einsum("bse,ehk->bshk", xu, params["wk"].to(dtype)) / \
        math.sqrt(hd)
    v = ctx.einsum("bse,ehk->bshk", xu, params["wv"].to(dtype))
    # on each rank's batch shard (logsigmoid's backward has no DTensor
    # sharding rule)
    logf, igate = ctx.batch_local(
        _mlstm_gates, (xu,), [params[k] for k in ("w_fgate", "w_igate",
                                                  "fgate_bias")], n_out=2)
    return q, k * igate[..., None].to(dtype), v, logf, z


def _mlstm_out(params: Params, y: torch.Tensor, z: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    b, s = z.shape[:2]
    y = y.reshape(b, s, -1) * F.silu(z)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    return ctx.einsum("bse,ed->bsd", y,
                      params["down_proj"].to(cfg.cdtype()))


def mlstm_forward(params: Params, x: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    q, k, v, logf, z = _mlstm_qkv(params, x, cfg)
    y = ctx.batch_local(
        lambda q, k, v, logf: chunked_linear_scan(v, k, q, logf,
                                                  cfg.ssm_chunk)[0],
        (q, k, v, logf))
    return _mlstm_out(params, y, z, cfg)


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None
                     ) -> torch.Tensor:
    d_in, h, hd = xlstm_dims(cfg)
    return torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                       device=runtime.device(device))


def mlstm_step(params: Params, x: torch.Tensor, state: torch.Tensor,
               cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    q, k, v, logf, z = _mlstm_qkv(params, x, cfg)
    state, y = ctx.batch_local(
        lambda state, q, k, v, logf: linear_scan_step(
            state, v[:, 0], k[:, 0], q[:, 0], logf[:, 0]),
        (state, q, k, v, logf), n_out=2)
    return _mlstm_out(params, y, z, cfg), state


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, sequential over time
# ---------------------------------------------------------------------------
def init_slstm(gen: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    dt = cfg.pdtype()
    return {
        "w_in": normal(gen, (d, 4, h, hd), 1 / math.sqrt(d), dt, device),
        "r": normal(gen, (4, h, hd, hd), 1 / math.sqrt(hd), dt, device),
        "bias": torch.zeros((4, h, hd), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d,), dtype=dt, device=device),
        "out_proj": normal(gen, (d, d), 1 / math.sqrt(2 * d * cfg.n_layers),
                           dt, device),
    }


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> Params:
    h = cfg.n_heads
    hd = cfg.d_model // h
    dev = runtime.device(device)
    return {name: torch.zeros((batch, h, hd), dtype=torch.float32,
                              device=dev)
            for name in ("c", "n", "hid", "m")}


def _slstm_cell(params: Params, xt: torch.Tensor, state: Params
                ) -> Tuple[Params, torch.Tensor]:
    """xt: [b, 4, h, hd] pre-activation from the input projection."""
    c, n, hid, m = state["c"], state["n"], state["hid"], state["m"]
    rec = torch.einsum("bhk,ghkl->bghl", hid.to(params["r"].dtype),
                       params["r"]).to(torch.float32)
    pre = xt.to(torch.float32) + rec + params["bias"][None]
    zt = torch.tanh(pre[:, 0])
    it = pre[:, 1]
    ft = pre[:, 2]
    ot = torch.sigmoid(pre[:, 3])
    # stabilized exponential gating
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * zt
    n_new = f_s * n + i_s
    hid_new = ot * c_new / torch.clamp_min(torch.abs(n_new), 1.0)
    return {"c": c_new, "n": n_new, "hid": hid_new, "m": m_new}, hid_new


#: the sLSTM state's tensors, in the order the local steps take them
SLSTM_STATE = ("c", "n", "hid", "m")


def _slstm_out(params: Params, y: torch.Tensor, cfg: ArchConfig
               ) -> torch.Tensor:
    dtype = cfg.cdtype()
    y = rmsnorm({"scale": params["norm_scale"]}, y.to(dtype), cfg.norm_eps)
    return ctx.einsum("bsd,de->bse", y, params["out_proj"].to(dtype))


def _slstm_scan(cfg: ArchConfig, xt: torch.Tensor, r: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The recurrence over time, xt [b, s, 4, h, hd] -> [b, s, d]."""
    b, s = xt.shape[:2]
    state = slstm_init_state(cfg, b, device=xt.device)
    outs = []
    with tracing.span("slstm_scan"):
        for t in range(s):
            state, out = _slstm_cell({"r": r, "bias": bias}, xt[:, t],
                                     state)
            outs.append(out)
    return torch.stack(outs, dim=1).reshape(b, s, cfg.d_model)


def slstm_forward(params: Params, x: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    """The projections split as the rules place their weights; the loop
    over time on each rank's shard of the batch (one local step a token,
    never a DTensor op)."""
    xt = ctx.einsum("bsd,dghk->bsghk", x, params["w_in"].to(cfg.cdtype()))
    y = ctx.batch_local(functools.partial(_slstm_scan, cfg), (xt,),
                        (params["r"], params["bias"]))
    return _slstm_out(params, y, cfg)


def _slstm_step_local(xt, c, n, hid, m, r, bias):
    state, out = _slstm_cell({"r": r, "bias": bias}, xt,
                             {"c": c, "n": n, "hid": hid, "m": m})
    return (*(state[k] for k in SLSTM_STATE), out)


def slstm_step(params: Params, x: torch.Tensor, state: Params,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    b, _, d = x.shape
    xt = ctx.einsum("bsd,dghk->bsghk", x,
                    params["w_in"].to(cfg.cdtype()))[:, 0]
    *new, out = ctx.batch_local(
        _slstm_step_local, (xt, *(state[k] for k in SLSTM_STATE)),
        (params["r"], params["bias"]), n_out=5)
    return (_slstm_out(params, out.reshape(b, 1, d), cfg),
            dict(zip(SLSTM_STATE, new)))
