"""Operations, bytes and peaks: the arithmetic of every utilization and
roofline share, from the configuration's own numbers (never from the
program).

A configuration is the dict of ``perfbench/configs/<name>.json``; its
``model`` holds the published sizes under their published keys.
"""
from __future__ import annotations

from typing import Dict, Optional

#: published dense peaks of one card, by ``torch.cuda.get_device_name()``
#: (NVIDIA's data sheet for the SXM part, without sparsity, at 700 W)
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peak(device_name: str) -> Optional[Dict[str, float]]:
    """The peaks of ``device_name``, or None for a card not in the table
    (its shares are then not measured)."""
    return PEAKS.get(device_name)


def dims(model: Dict) -> Dict[str, int]:
    """The sizes the counts need, from a configuration's ``model``."""
    d = int(model["hidden_size"])
    h = int(model["num_attention_heads"])
    return {"d": d, "layers": int(model["num_hidden_layers"]), "heads": h,
            "kv_heads": int(model["num_key_value_heads"]),
            "head_dim": int(model.get("head_dim") or d // h),
            "ff": int(model["intermediate_size"]),
            "vocab": int(model["vocab_size"]),
            "experts": int(model.get("num_local_experts", 0)),
            "top_k": int(model.get("num_experts_per_tok", 0)),
            "tied": bool(model["tie_word_embeddings"]),
            "qkv_bias": bool(model.get("qkv_bias", False))}


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a top-left aligned causal mask keeps: row i sees
    min(i + 1, skv) keys."""
    tri = min(sq, skv)
    return tri * (tri + 1) // 2 + max(sq - skv, 0) * skv


def attention_params(m: Dict[str, int]) -> int:
    """One layer's attention projections (q, k, v, o)."""
    return m["d"] * m["head_dim"] * (2 * m["heads"] + 2 * m["kv_heads"])


def n_params(model: Dict, experts: Optional[int] = None) -> int:
    """Every parameter, the tied embedding once; with ``experts``, only
    that many experts of each MoE layer are counted (the router whole)."""
    m = dims(model)
    bias = (m["heads"] + 2 * m["kv_heads"]) * m["head_dim"] \
        if m["qkv_bias"] else 0
    if m["experts"]:
        e = m["experts"] if experts is None else experts
        ffn = e * 3 * m["d"] * m["ff"] + m["d"] * m["experts"]
    else:
        ffn = 3 * m["d"] * m["ff"]
    layer = attention_params(m) + bias + ffn + 2 * m["d"]
    embed = m["vocab"] * m["d"] * (1 if m["tied"] else 2)
    return m["layers"] * layer + embed + m["d"]


def active_params(model: Dict) -> int:
    """The parameters one token meets: every one of a dense model, and the
    top-k experts of each MoE layer."""
    return n_params(model, dims(model)["top_k"] or None)


def active_matmul_params(model: Dict) -> int:
    """Parameters one token meets in the layers' matrix products: the
    attention projections, the router and the top-k experts (or the dense
    MLP); no embedding, norm or bias."""
    m = dims(model)
    if m["experts"]:
        ffn = m["top_k"] * 3 * m["d"] * m["ff"] + m["d"] * m["experts"]
    else:
        ffn = 3 * m["d"] * m["ff"]
    return m["layers"] * (attention_params(m) + ffn)


def attention_fwd_flops(model: Dict, batch: int, seq: int) -> float:
    """The causal attention products of one forward, every layer:
    4 B H D x kept pairs a layer."""
    m = dims(model)
    return 4.0 * batch * m["heads"] * m["head_dim"] * \
        causal_pairs(seq, seq) * m["layers"]


def train_flops(model: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step, recompute not counted: 6 N T for
    the products of the parameters a token meets (the tied embedding's one
    product included; of an MoE layer the top-k experts) plus the
    attention products, backward twice the forward (frozen from the
    port's ``chip_smoke.train_flops``, which counts a dense model)."""
    return 6.0 * active_params(model) * batch * seq + \
        3.0 * attention_fwd_flops(model, batch, seq)


def prefill_flops(model: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill that returns the last position's
    logits: 2 x the active matrix parameters x T, the causal attention
    products, and the last token's unembedding."""
    m = dims(model)
    return 2.0 * active_matmul_params(model) * batch * seq + \
        attention_fwd_flops(model, batch, seq) + \
        2.0 * m["d"] * m["vocab"] * batch


def k5_fwd(batch: int, heads: int, kv_heads: int, sq: int, skv: int,
           head_dim: int, elem_bytes: int, causal: bool = True
           ) -> Dict[str, float]:
    """One call of K5's forward: 4 B H D x kept pairs; q, k, v read once,
    the output and each row's float32 log-sum-exp written once."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    q = batch * sq * heads * head_dim
    kv = batch * skv * kv_heads * head_dim
    lse = batch * heads * sq
    return {"flops": 4.0 * batch * heads * head_dim * pairs,
            "bytes": float(elem_bytes * (2 * q + 2 * kv) + 4 * lse)}


def k5_bwd(batch: int, heads: int, kv_heads: int, sq: int, skv: int,
           head_dim: int, elem_bytes: int, causal: bool = True
           ) -> Dict[str, float]:
    """One call of K5's backward: 10 B H D x kept pairs; q, k, v, o, dO and
    the log-sum-exp read once, dq, dk, dv written once."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    q = batch * sq * heads * head_dim
    kv = batch * skv * kv_heads * head_dim
    lse = batch * heads * sq
    return {"flops": 10.0 * batch * heads * head_dim * pairs,
            "bytes": float(elem_bytes * (4 * q + 4 * kv) + 4 * lse)}


def least_seconds(work: Dict[str, float], peaks: Dict[str, float],
                  flops_key: str = "bf16_flops") -> float:
    """The least time the card could take: the larger of the operations
    at the peak rate and the bytes at the memory bandwidth."""
    return max(work["flops"] / peaks[flops_key],
               work["bytes"] / peaks["hbm_bytes_s"])
