"""A plain decoder-only transformer in float32: the dense (Qwen2) and the
mixture-of-experts (Granite MoE) blocks, their causal-LM loss, gradients
and AdamW.

Written from the published equations: RMSNorm, rotate-half RoPE, grouped
query attention with a causal mask and a full softmax, SwiGLU MLP, and
for the MoE layer a softmax router, top-k experts with their gates
renormalised, and a capacity of ceil(T k c / E) tokens an expert filled
in token order (assigned tokens first); an assignment past capacity is
dropped and the residual carries the token past that expert.  The
departures of the configurations from their published models are listed
in their files.

Weights come in as a dict from dotted path to float32 tensor, with the
parameter layout's names (``layers.3.attn.wq`` [d, H, hd] and so on).
``Matmul`` is the one place a product is taken, so the same code runs
in float32 (TF32 off) and, as the control, with every operand of the
compute-dtype products rounded to float8 (e4m3, one scale a tensor).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]

FP8_MAX = 448.0


@contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale (amax / 448) and back
    to float32."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Product(torch.autograd.Function):
    """a @ b with both operands rounded to float8, and the products of the
    backward pass likewise."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_round(a) @ fp8_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = fp8_round(g)
        return g8 @ fp8_round(b).mT, fp8_round(a).mT @ g8


class Matmul:
    """The products of the compute dtype: float32, or ``"fp8"`` for the
    control."""

    def __init__(self, precision: str = "float32") -> None:
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Product.apply(a, b)
        return a @ b


class Decoder:
    """The model of one configuration's ``model`` numbers."""

    def __init__(self, model: Dict, matmul: Optional[Matmul] = None) -> None:
        self.d = int(model["hidden_size"])
        self.layers = int(model["num_hidden_layers"])
        self.heads = int(model["num_attention_heads"])
        self.kv_heads = int(model["num_key_value_heads"])
        self.hd = int(model.get("head_dim") or self.d // self.heads)
        self.ff = int(model["intermediate_size"])
        self.vocab = int(model["vocab_size"])
        self.theta = float(model["rope_theta"])
        self.eps = float(model["rms_norm_eps"])
        self.tied = bool(model["tie_word_embeddings"])
        self.experts = int(model.get("num_local_experts", 0))
        self.top_k = int(model.get("num_experts_per_tok", 0))
        self.capacity_factor = float(model.get("capacity_factor", 0.0))
        self.aux_coef = float(model.get("router_aux_loss_coef", 0.0))
        self.mm = matmul or Matmul()

    # ---- blocks ---------------------------------------------------------
    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * scale

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, n, hd] at positions 0..S-1 (rotate-half)."""
        s = x.shape[1]
        inv = self.theta ** (-torch.arange(0, self.hd, 2, device=x.device,
                                           dtype=torch.float32) / self.hd)
        ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
            * inv[None, :]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :self.hd // 2], x[..., self.hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

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
        if p + "bq" in W:
            q = q + W[p + "bq"]
            k = k + W[p + "bk"]
            v = v + W[p + "bv"]
        q, k = self.rope(q), self.rope(k)
        group = self.heads // self.kv_heads
        mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        rows = []
        for r in range(b):                      # one sequence at a time
            qr = q[r].transpose(0, 1)                           # [H, S, hd]
            kr = k[r].transpose(0, 1).repeat_interleave(group, 0)
            vr = v[r].transpose(0, 1).repeat_interleave(group, 0)
            scores = self.mm(qr, kr.mT) / math.sqrt(self.hd)
            scores = scores.masked_fill(~mask, float("-inf"))
            rows.append(self.mm(torch.softmax(scores, -1), vr))
        o = torch.stack(rows).transpose(1, 2).reshape(b * s, -1)
        return self.mm(o, W[p + "wo"].reshape(-1, d)).view(b, s, d)

    def mlp(self, W: Weights, i: int, h: torch.Tensor) -> torch.Tensor:
        b, s, d = h.shape
        p = f"layers.{i}.mlp."
        h2 = h.reshape(b * s, d)
        g = self.mm(h2, W[p + "w_gate"])
        u = self.mm(h2, W[p + "w_up"])
        return self.mm(F.silu(g) * u, W[p + "w_down"]).view(b, s, d)

    def capacity(self, tokens: int) -> int:
        c = math.ceil(tokens * self.top_k * self.capacity_factor /
                      self.experts)
        return max(min(c, tokens), 1)

    def moe(self, W: Weights, i: int, h: torch.Tensor):
        """The expert layer over all B x S tokens of the batch at once (the
        capacity is the batch's), and its load-balancing loss."""
        b, s, d = h.shape
        t, e = b * s, self.experts
        p = f"layers.{i}.moe."
        x = h.reshape(t, d)
        probs = torch.softmax(x @ W[p + "router"], -1)       # float32 router
        gate, idx = torch.topk(probs, self.top_k, -1)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        chosen = torch.zeros(t, e, device=x.device).scatter_(1, idx, 1.0)
        weight = torch.zeros(t, e, device=x.device).scatter_(1, idx, gate)
        c = self.capacity(t)
        # each expert keeps its first c assigned tokens, in token order
        order = chosen.T * (2.0 * t) - torch.arange(t, device=x.device)
        ids = torch.topk(order, c, -1).indices                   # [E, C]
        kept = torch.gather(chosen.T, 1, ids)                    # [E, C]
        xe = x[ids] * kept[..., None]                            # [E, C, d]
        g = self.mm(xe, W[p + "w_gate"])
        u = self.mm(xe, W[p + "w_up"])
        out = self.mm(F.silu(g) * u, W[p + "w_down"])             # [E, C, d]
        out = out * torch.gather(weight.T, 1, ids)[..., None]
        y = torch.zeros(t, d, device=x.device).index_add(
            0, ids.reshape(-1), out.reshape(-1, d))
        aux = (chosen.mean(0) * probs.mean(0)).sum() * e
        return y.view(b, s, d), aux

    def layer(self, W: Weights, i: int, x: torch.Tensor):
        x = x + self.attention(W, i, self.rmsnorm(x, W[f"layers.{i}.ln1.scale"]))
        h = self.rmsnorm(x, W[f"layers.{i}.ln2.scale"])
        if self.experts:
            y, aux = self.moe(W, i, h)
        else:
            y, aux = self.mlp(W, i, h), torch.zeros((), device=x.device)
        return x + y, aux

    def hidden(self, W: Weights, tokens: torch.Tensor, remat: bool = False):
        """The final-norm hidden states [B, S, d] and the summed auxiliary
        loss; ``remat`` recomputes each layer in the backward pass."""
        x = W["embed.tok"][tokens.long()]
        aux = torch.zeros((), device=x.device)
        for i in range(self.layers):
            if remat:
                x, a = checkpoint(self.layer, W, i, x, use_reentrant=False)
            else:
                x, a = self.layer(W, i, x)
            aux = aux + a
        return self.rmsnorm(x, W["final_norm.scale"]), aux

    def logits(self, W: Weights, x: torch.Tensor) -> torch.Tensor:
        """x [N, d] -> logits [N, V]."""
        table = W["embed.tok"].T if self.tied else W["embed.head"]
        return self.mm(x, table)

    # ---- serving --------------------------------------------------------
    @torch.no_grad()
    def last_logits(self, W: Weights, tokens: torch.Tensor) -> torch.Tensor:
        """The last position's logits [B, V] of prompts [B, S], the batch
        routed together."""
        x, _ = self.hidden(W, tokens)
        return self.logits(W, x[:, -1])

    # ---- training -------------------------------------------------------
    def _ce_sum(self, W: Weights, x: torch.Tensor, labels: torch.Tensor):
        lg = self.logits(W, x)
        return (torch.logsumexp(lg, -1) -
                lg.gather(-1, labels[:, None].long())[:, 0]).sum()

    def loss(self, W: Weights, tokens: torch.Tensor, labels: torch.Tensor,
             chunk: int = 4096):
        """(mean next-token cross-entropy, total loss with the auxiliary
        term), the logits taken ``chunk`` rows at a time and recomputed
        in the backward pass."""
        x, aux = self.hidden(W, tokens, remat=True)
        x = x.reshape(-1, self.d)
        lab = labels.reshape(-1)
        ce = torch.zeros((), device=x.device)
        for a in range(0, x.shape[0], chunk):
            ce = ce + checkpoint(self._ce_sum, W, x[a:a + chunk],
                                 lab[a:a + chunk], use_reentrant=False)
        ce = ce / x.shape[0]
        return ce, ce + self.aux_coef * aux


def learning_rate(step: int, opt: Dict) -> float:
    """Linear warm-up, then a cosine to a tenth of the peak."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    progress = min(max((step - opt["warmup_steps"]) /
                       max(opt["total_steps"] - opt["warmup_steps"], 1),
                       0.0), 1.0)
    return opt["learning_rate"] * warm * \
        (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * progress)))


def train(dec: Decoder, W: Weights, batches: List[Dict[str, torch.Tensor]],
          opt: Dict) -> Dict:
    """AdamW steps on ``W`` (changed in place), one a batch, after the
    gradient is clipped to a global norm of ``opt["grad_clip"]``.
    Returns each step's loss and each leaf's norm of the first step's
    clipped gradient."""
    names = list(W)
    for n in names:
        W[n].requires_grad_(True)
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    b1, b2 = opt["b1"], opt["b2"]
    losses, first_grad = [], {}
    for t, batch in enumerate(batches, start=1):
        ce, total = dec.loss(W, batch["tokens"], batch["labels"])
        grads = torch.autograd.grad(total, [W[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(W[n]) if g is None else g
                 for n, g in zip(names, grads)]
        losses.append(float(ce.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            clip = torch.clamp(opt["grad_clip"] / norm.clamp_min(1e-9),
                               max=1.0)
            lr = learning_rate(t, opt)
            for n, g in zip(names, grads):
                g = g * clip
                if t == 1:
                    first_grad[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = (m[n] / (1 - b1 ** t)) / \
                    (torch.sqrt(v[n] / (1 - b2 ** t)) + opt["eps"])
                W[n].sub_(lr * (step + opt["weight_decay"] * W[n]))
        del grads
    for n in names:
        W[n].requires_grad_(False)
    return {"losses": losses, "first_grad": first_grad}
