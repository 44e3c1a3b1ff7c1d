"""Granite 4.0-H (HF ``GraniteMoeHybrid``) in float32: Mamba2 and NoPE
grouped-query attention as token mixers by ``layer_types``, each layer
followed by routed experts and a shared expert, under Granite's four
multipliers.  A subclass of ``decoder.Decoder``, whose RMSNorm, capacity
rule and ``Matmul`` it takes as they are.

Written from the published equations, apart from the program:

- Mamba2 (Dao and Gu, arXiv:2405.21060): ``in_proj`` to z, x, B, C and dt;
  a depthwise causal convolution (``F.conv1d``) with bias over x, B, C and
  SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD in the
  paper's minimal chunked form (its ``ssd_minimal_discrete`` listing, with
  ``segsum``), a slice of heads at a time (heads are independent; head i
  reads group i // (heads / groups)); y + D x; RMSNorm of y silu(z) over
  the whole inner width (one group); ``out_proj``.
- Attention without rotary embeddings (NoPE): softmax(q k^T x
  attention_multiplier) v, one block of queries at a time against the
  keys up to the block's end, a full softmax a block.
- The MoE layer: ``decoder.Decoder``'s router and capacity (a softmax
  router, top-k with the gates renormalised, which is the softmax over the
  top-k logits; each expert keeps its first ceil(T k c / E) assigned
  tokens), the experts a few at a time; plus the shared SwiGLU expert on
  the same normed input.
- The layer: x + r mixer(rmsnorm(x)), then x + r (moe(h) + shared(h)) with
  h = rmsnorm(x); embeddings times ``embedding_multiplier``; tied logits
  over ``logits_scaling``.

Departures from HF ``GraniteMoeHybrid``, which the program shares: the
experts' capacity (factor 1.25) where the source is dropless; the router's
product and gates in float32 where the source casts the gates to the
model's dtype; float32 throughout (TF32 off) where the source serves in
bf16.  The control (``Matmul("fp8")``) rounds the products that go
through ``self.mm``: the projections, the attention's two products, the
experts and the logits; the SSD's einsums stay float32.

Weights come as the drawn dict (bf16, the router float32) with the
program's layout names (``layers.3.mamba.in_proj`` and so on); each
layer's are cast to float32 only while that layer runs, so the cut model,
65 GB in float32, is never held in float32 whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import decoder

Weights = Dict[str, torch.Tensor]

#: elements of the SSD's largest per-head tensors ([b, c, l, heads, l])
#: and of the attention's scores held at once
BLOCK_ELEMENTS = 1 << 27
#: experts a block of the MoE layer computes at once
EXPERT_BLOCK = 8


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = x[..., j+1] + ... + x[..., i] below the diagonal,
    -inf above it, so exp(segsum(A)) is the 1-semiseparable decay
    (the listing's naive segment sum)."""
    t = x.size(-1)
    x_cumsum = torch.cumsum(x, dim=-1)
    x_segsum = x_cumsum[..., :, None] - x_cumsum[..., None, :]
    mask = torch.tril(torch.ones(t, t, device=x.device, dtype=torch.bool),
                      diagonal=0)
    return x_segsum.masked_fill(~mask, -torch.inf)


def _chunks(x: torch.Tensor, block_len: int) -> torch.Tensor:
    """[b, (c l), ...] -> [b, c, l, ...]."""
    return x.reshape(x.shape[0], -1, block_len, *x.shape[2:])


def ssd_minimal_discrete(X, A, B, C, block_len, initial_states=None):
    """The SSD listing of arXiv:2405.21060.  X [b, L, h, p], A [b, L, h]
    (dt A), B and C [b, L, h, n], L a multiple of ``block_len``; returns
    (Y [b, L, h, p], the final state [b, h, p, n])."""
    X, A, B, C = (_chunks(t, block_len) for t in (X, A, B, C))
    A = A.permute(0, 3, 1, 2)                               # b h c l
    A_cumsum = torch.cumsum(A, dim=-1)

    # 1. the output of each chunk from its own inputs (diagonal blocks)
    L = torch.exp(segsum(A))
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)

    # 2. each chunk's state from its inputs (the B terms)
    decay_states = torch.exp(A_cumsum[:, :, :, -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)

    # 3. the recurrence between chunks: the states at chunk boundaries
    if initial_states is None:
        initial_states = torch.zeros_like(states[:, :1])
    states = torch.cat([initial_states, states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[:, :, :, -1], (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. each chunk's output from the state it starts in (the C terms)
    state_decay_out = torch.exp(A_cumsum)
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         state_decay_out)
    Y = Y_diag + Y_off
    return Y.reshape(Y.shape[0], -1, *Y.shape[3:]), final_state


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        block_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD over any length, a slice of heads at a time: X [b, L, h,
    p], A [b, L, h], B and C [b, L, g, n] (head i reads group i // (h /
    g)).  The length is padded to a chunk multiple with zero inputs and
    zero log-decay, which leave the state as it is.  Returns (Y [b, L, h,
    p], the final state [b, h, p, n])."""
    b, s, h, _ = X.shape
    g = B.shape[2]
    pad = -s % block_len
    if pad:
        X, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (X, B, C))
        A = F.pad(A, (0, 0, 0, pad))
    per = max(1, BLOCK_ELEMENTS // (b * (s + pad) * block_len))
    ys, finals = [], []
    for h0 in range(0, h, per):
        heads = torch.arange(h0, min(h, h0 + per), device=X.device)
        groups = heads // (h // g)
        y, final = ssd_minimal_discrete(X[:, :, heads], A[:, :, heads],
                                        B[:, :, groups], C[:, :, groups],
                                        block_len)
        ys.append(y)
        finals.append(final)
    return torch.cat(ys, dim=2)[:, :s], torch.cat(finals, dim=1)


class GraniteHybrid(decoder.Decoder):
    """The model of one configuration's ``model`` numbers."""

    def __init__(self, model: Dict,
                 matmul: Optional[decoder.Matmul] = None) -> None:
        super().__init__(model, matmul)
        self.layer_types = list(model["layer_types"])
        self.shared_ff = int(model["shared_intermediate_size"])
        self.ssm_heads = int(model["mamba_n_heads"])
        self.ssm_hd = int(model["mamba_d_head"])
        self.ssm_state = int(model["mamba_d_state"])
        self.ssm_groups = int(model["mamba_n_groups"])
        self.ssm_chunk = int(model["mamba_chunk_size"])
        self.conv_width = int(model["mamba_d_conv"])
        self.d_in = int(model["mamba_expand"]) * self.d
        self.emb_mult = float(model["embedding_multiplier"])
        self.attn_mult = float(model["attention_multiplier"])
        self.res_mult = float(model["residual_multiplier"])
        self.logits_scaling = float(model["logits_scaling"])

    # ---- token mixers -----------------------------------------------------
    def mamba(self, W: Weights, i: int, h: torch.Tensor) -> torch.Tensor:
        b, s, d = h.shape
        p = f"layers.{i}.mamba."
        heads, gn = self.ssm_heads, self.ssm_groups * self.ssm_state
        proj = self.mm(h.reshape(b * s, d), W[p + "in_proj"]).view(b, s, -1)
        z, xbc, dt = proj.split([self.d_in, self.d_in + 2 * gn, heads], -1)
        conv = F.conv1d(xbc.transpose(1, 2), W[p + "conv_w"].T[:, None, :],
                        W[p + "conv_b"], padding=self.conv_width - 1,
                        groups=xbc.shape[-1])[..., :s]
        x, B, C = F.silu(conv).transpose(1, 2).split(
            [self.d_in, gn, gn], -1)
        dt = F.softplus(dt + W[p + "dt_bias"])                  # [b, s, H]
        A = -torch.exp(W[p + "A_log"])
        x = x.reshape(b, s, heads, self.ssm_hd)
        y, _ = ssd(x * dt[..., None], A * dt,
                   B.reshape(b, s, self.ssm_groups, self.ssm_state),
                   C.reshape(b, s, self.ssm_groups, self.ssm_state),
                   self.ssm_chunk)
        y = (y + W[p + "D_skip"][:, None] * x).reshape(b, s, self.d_in)
        y = self.rmsnorm(y * F.silu(z), W[p + "norm_scale"])
        return self.mm(y.reshape(b * s, -1), W[p + "out_proj"]).view(b, s, d)

    def attention(self, W: Weights, i: int, h: torch.Tensor) -> torch.Tensor:
        b, s, d = h.shape
        p = f"layers.{i}.attn."
        h2 = h.reshape(b * s, d)
        q = self.mm(h2, W[p + "wq"].reshape(d, -1)).view(b, s, self.heads,
                                                         self.hd)
        k = self.mm(h2, W[p + "wk"].reshape(d, -1)).view(b, s, self.kv_heads,
                                                         self.hd)
        v = self.mm(h2, W[p + "wv"].reshape(d, -1)).view(b, s, self.kv_heads,
                                                         self.hd)
        group = self.heads // self.kv_heads
        rows = max(1, BLOCK_ELEMENTS // (self.heads * s))
        out = torch.empty_like(q)
        pos = torch.arange(s, device=h.device)
        for r in range(b):                      # one sequence at a time
            kr = k[r].transpose(0, 1).repeat_interleave(group, 0)
            vr = v[r].transpose(0, 1).repeat_interleave(group, 0)
            for q0 in range(0, s, rows):        # a block of queries
                q1 = min(s, q0 + rows)
                qr = q[r, q0:q1].transpose(0, 1)             # [H, n, hd]
                scores = self.mm(qr, kr[:, :q1].mT) * self.attn_mult
                mask = pos[q0:q1, None] >= pos[None, :q1]
                scores = scores.masked_fill(~mask, float("-inf"))
                out[r, q0:q1] = self.mm(torch.softmax(scores, -1),
                                        vr[:, :q1]).transpose(0, 1)
        return self.mm(out.reshape(b * s, -1),
                       W[p + "wo"].reshape(-1, d)).view(b, s, d)

    # ---- the feed-forward half -------------------------------------------
    def moe(self, W: Weights, i: int, h: torch.Tensor):
        """The routed experts over all B x S tokens of the batch at once
        (the capacity is the batch's), ``EXPERT_BLOCK`` experts at a
        time."""
        b, s, d = h.shape
        t, e = b * s, self.experts
        p = f"layers.{i}.moe."
        x = h.reshape(t, d)
        probs = torch.softmax(x @ W[p + "router"], -1)
        gate, idx = torch.topk(probs, self.top_k, -1)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        chosen = torch.zeros(t, e, device=x.device).scatter_(1, idx, 1.0)
        weight = torch.zeros(t, e, device=x.device).scatter_(1, idx, gate)
        c = self.capacity(t)
        order = chosen.T * (2.0 * t) - torch.arange(t, device=x.device)
        ids = torch.topk(order, c, -1).indices                   # [E, C]
        kept = torch.gather(chosen.T, 1, ids)
        gates = torch.gather(weight.T, 1, ids)
        y = torch.zeros(t, d, device=x.device)
        for e0 in range(0, e, EXPERT_BLOCK):
            blk = slice(e0, e0 + EXPERT_BLOCK)
            xe = x[ids[blk]] * kept[blk, :, None]
            g = self.mm(xe, W[p + "w_gate"][blk])
            u = self.mm(xe, W[p + "w_up"][blk])
            out = self.mm(F.silu(g) * u, W[p + "w_down"][blk])
            y.index_add_(0, ids[blk].reshape(-1),
                         (out * gates[blk, :, None]).reshape(-1, d))
        return y.view(b, s, d)

    def shared(self, W: Weights, i: int, h: torch.Tensor) -> torch.Tensor:
        b, s, d = h.shape
        p = f"layers.{i}.shared."
        h2 = h.reshape(b * s, d)
        g = self.mm(h2, W[p + "w_gate"])
        u = self.mm(h2, W[p + "w_up"])
        return self.mm(F.silu(g) * u, W[p + "w_down"]).view(b, s, d)

    # ---- the model --------------------------------------------------------
    def layer(self, W: Weights, i: int, x: torch.Tensor) -> torch.Tensor:
        h = self.rmsnorm(x, W[f"layers.{i}.ln1.scale"])
        mix = self.mamba if self.layer_types[i] == "mamba" else \
            self.attention
        x = x + self.res_mult * mix(W, i, h)
        h = self.rmsnorm(x, W[f"layers.{i}.ln2.scale"])
        return x + self.res_mult * (self.moe(W, i, h) + self.shared(W, i, h))

    def hidden(self, W: Weights, tokens: torch.Tensor) -> torch.Tensor:
        """The final-norm hidden states [B, S, d]; each layer's weights in
        float32 only while it runs."""
        x = W["embed.tok"][tokens.long()].float() * self.emb_mult
        for i in range(self.layers):
            prefix = f"layers.{i}."
            Wl = {k: v.float() for k, v in W.items() if k.startswith(prefix)}
            x = self.layer(Wl, i, x)
            del Wl
        return self.rmsnorm(x, W["final_norm.scale"].float())

    def logits(self, W: Weights, x: torch.Tensor) -> torch.Tensor:
        """x [N, d] -> logits [N, V] (the tied table)."""
        return self.mm(x, W["embed.tok"].float().T) / self.logits_scaling

    @torch.no_grad()
    def last_logits(self, W: Weights, tokens: torch.Tensor) -> torch.Tensor:
        """The last position's logits [B, V] of prompts [B, S], the batch
        routed together."""
        return self.logits(W, self.hidden(W, tokens)[:, -1])

    @torch.no_grad()
    def all_logits(self, W: Weights, tokens: torch.Tensor) -> torch.Tensor:
        """Every position's logits [B, S, V]."""
        x = self.hidden(W, tokens)
        return self.logits(W, x.reshape(-1, self.d)).view(*x.shape[:2], -1)


#: the class ``drivers/prefill_long.py`` takes from this module
Model = GraniteHybrid
