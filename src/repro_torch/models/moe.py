"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch
(the port of ``repro/models/moe.py``).

Per expert, the assigned token ids are picked by a top-capacity selection,
the tokens gathered to [E, C, D], the expert FFNs applied as batched
products over the expert axis, and the outputs combined, weighted by the
router gates.  The expert products stay ``torch.bmm``: the reference
leaves them to XLA, outside any Pallas kernel.

Both top-k selections are tie-free where it matters: the capacity
priority ``mask * 2T - t`` holds distinct integers (exact in float32 for
T < 2^23), so ``torch.topk`` picks the reference's ``lax.top_k`` tokens;
the gate top-k ties only on equal router probabilities.

The combine takes one of two forms, by what it is given.  On CUDA tensors
that autograd does not record (serving: prefill and decode run under
``torch.no_grad``) it is the ``moe_combine`` kernel: each token gathers
the rows of the slots that took it and sums them in float32, in the order
of its top-k list, with the float32 gates; no padding slot is read, and
two runs are bit-equal.  Elsewhere (the CPU, and a forward that autograd
records, such as a MoE training step) it is :func:`combine_scatter`, the
reference's scatter-add as a compute-dtype ``index_add_`` over every
slot, whose float order on CUDA is not fixed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import records_grad
from repro_torch.kernels.moe_combine.ops import moe_combine
from repro_torch.models.layers import normal
from repro_torch.parallel import ctx

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    scale = 1.0 / math.sqrt(d)
    out_scale = 1.0 / math.sqrt(f * 2 * cfg.n_layers)
    dt = cfg.pdtype()
    return {
        "router": normal(gen, (d, e), scale, torch.float32, device),
        "w_gate": normal(gen, (e, d, f), scale, dt, device),
        "w_up": normal(gen, (e, d, f), scale, dt, device),
        "w_down": normal(gen, (e, f, d), out_scale, dt, device),
    }


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    moe = cfg.moe
    c = int(math.ceil(n_tokens * moe.top_k * moe.capacity_factor /
                      moe.n_experts))
    return max(min(c, n_tokens), 1)


#: the keys of :func:`route`'s result, in the order its local step gives
ROUTE_KEYS = ("gate_idx", "token_ids", "mask", "gathered_mask", "combine_w",
              "aux")


def _route(logits: torch.Tensor, cfg: ArchConfig):
    """The router's decisions from its logits [T, E], in ROUTE_KEYS'
    order."""
    moe = cfg.moe
    t = logits.shape[0]
    e, k = moe.n_experts, moe.top_k
    c = capacity(t, cfg)
    probs = torch.softmax(logits, dim=-1)                     # [T, E]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)        # [T, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    assign = F.one_hot(gate_idx, e).to(torch.float32)         # [T, k, E]
    mask = assign.sum(dim=1)                                  # [T, E]
    combine_w = (assign * gate_vals[..., None]).sum(dim=1)    # [T, E]

    # load-balancing auxiliary loss (Switch-style)
    density = mask.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * (e ** 2) / e

    # top-C tokens per expert by priority (assigned first, then in order)
    priority = mask.T * (t * 2.0) - torch.arange(
        t, dtype=torch.float32, device=logits.device)[None, :]
    token_ids = torch.topk(priority, c, dim=1).indices        # [E, C]
    gathered_mask = torch.gather(mask.T, 1, token_ids)        # [E, C]
    return gate_idx, token_ids, mask, gathered_mask, combine_w, aux


def route(params: Params, xt: torch.Tensor, cfg: ArchConfig
          ) -> Dict[str, torch.Tensor]:
    """The router's decisions for tokens ``xt`` [T, D]: ``gate_idx`` [T, k]
    (experts by falling probability), ``token_ids`` [E, C] (each expert's
    tokens by priority), the assignment ``mask`` [T, E], ``gathered_mask``
    [E, C] (0 where an expert's slot is padding), the gate weights
    ``combine_w`` [T, E] and the Switch auxiliary loss ``aux``.  On a
    mesh, every rank routes every token (``ctx.replicated_local``)."""
    logits = ctx.einsum("td,de->te", xt.to(torch.float32),
                        params["router"].to(torch.float32))
    out = ctx.replicated_local(lambda lg: _route(lg, cfg), (logits,),
                               n_out=len(ROUTE_KEYS))
    return dict(zip(ROUTE_KEYS, out))


def dropped(r: Dict[str, torch.Tensor]) -> int:
    """(token, expert) assignments of :func:`route`'s result that no
    capacity slot took (those tokens pass that expert by)."""
    return int(r["mask"].sum() - r["gathered_mask"].sum())


def combine_scatter(out: torch.Tensor, combine_w: torch.Tensor,
                    token_ids: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """y [T, D] in ``out``'s dtype: every slot's row of ``out`` [E, C, D],
    times its token's gate rounded to that dtype, scatter-added into its
    token's row (a padding slot adds its row times a zero gate)."""
    e, c, d = out.shape
    w = torch.gather(combine_w.T, 1, token_ids)              # [E, C]
    flat_out = (out * w[..., None].to(out.dtype)).reshape(e * c, d)
    return torch.zeros((n_tokens, d), dtype=out.dtype,
                       device=out.device).index_add_(
        0, token_ids.reshape(-1), flat_out)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss). Capacity-dropped tokens pass through
    (the residual connection supplies the identity).

    Under a profiler the layer is a ``moe_ffn`` span holding, in order,
    ``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``,
    and after it tallies ``moe.assigned`` (T k) and ``moe.kept``
    (assignments a slot took; ``moe.assigned - moe.kept`` is
    :func:`dropped`), with one kernel outside the spans."""
    with tracing.span("moe_ffn"):
        b, s, d = x.shape
        t = b * s
        e = cfg.moe.n_experts
        dtype = cfg.cdtype()
        with tracing.span("moe.route"):
            # the routing is global, as the reference's: on a mesh every
            # rank routes every token (the tokens gathered, flattened
            # locally: a DTensor view of the split batch and sequence as
            # one dim leaves its backward a strided shard), and the experts
            # run split by the expert constraint
            xt = ctx.replicated_local(lambda x: x.reshape(t, d), (x,))
            r = route(params, xt, cfg)
            token_ids = r["token_ids"]
            c = token_ids.shape[1]

        def dispatch(xt, ids, gm):
            xg = xt[ids.reshape(-1)].reshape(e, c, d).to(dtype)
            return xg * gm[..., None].to(dtype)              # zero padding

        with tracing.span("moe.dispatch"):
            xg = ctx.replicated_local(dispatch, (xt, token_ids,
                                                 r["gathered_mask"]))
            # expert-parallel dispatch: [E, C, D] split on the expert axis
            xg = ctx.constrain_experts(xg)
        with tracing.span("moe.experts"):
            gate = ctx.einsum("ecd,edf->ecf", xg, params["w_gate"].to(dtype))
            up = ctx.einsum("ecd,edf->ecf", xg, params["w_up"].to(dtype))
            out = ctx.constrain_experts(ctx.einsum(
                "ecf,efd->ecd", F.silu(gate) * up,
                params["w_down"].to(dtype)))

        # combine: the expert outputs weighted by the router gates, by
        # token (the kernel) or by slot (the scatter-add; see the module)
        def combine(out, combine_w, gate_idx, ids, gm):
            if out.is_cuda and not records_grad(out, combine_w):
                y = moe_combine(out, combine_w, gate_idx, ids, gm)
            else:
                y = combine_scatter(out, combine_w, ids, t)
            return y.reshape(b, s, d)

        with tracing.span("moe.combine"):
            y = ctx.replicated_local(combine, (out, r["combine_w"],
                                               r["gate_idx"], token_ids,
                                               r["gathered_mask"]))
    if tracing.recording():
        tracing.tally("moe.assigned", t * cfg.moe.top_k)
        tracing.tally("moe.kept", r["gathered_mask"].sum())
    return y, r["aux"].to(torch.float32)
