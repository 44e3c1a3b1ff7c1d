"""The work of a hybrid model's prefill (Mamba2 and attention mixers, routed
and shared experts), from a configuration's published keys: the chunked
SSD scan's operations and bytes, whatever computes it, and the model
FLOPs of a prefill.

A configuration's ``model`` names Mamba2's sizes as HF does:
``mamba_n_heads``, ``mamba_d_head``, ``mamba_d_state``, ``mamba_n_groups``,
``mamba_chunk_size``, ``mamba_expand``; the layer kinds in
``layer_types`` ("mamba" or "attention"); the shared expert's width in
``shared_intermediate_size``.
"""
from __future__ import annotations

from typing import Dict, Optional

from perfbench.yardstick import flops


def mamba_dims(model: Dict) -> Dict[str, int]:
    return {"heads": int(model["mamba_n_heads"]),
            "head_dim": int(model["mamba_d_head"]),
            "state": int(model["mamba_d_state"]),
            "groups": int(model["mamba_n_groups"]),
            "chunk": int(model["mamba_chunk_size"]),
            "d_inner": int(model["mamba_expand"]) *
            int(model["hidden_size"])}


def chunk_pairs(seq: int, chunk: int) -> int:
    """(position, earlier-or-same position) pairs inside the chunks of a
    sequence cut into ``chunk``-long pieces, the last one shorter."""
    whole, rest = divmod(seq, chunk)
    return whole * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2


def ssd_scan(batch: int, seq: int, heads: int, head_dim: int, state: int,
             groups: int, chunk: int, elem_bytes: int) -> Dict[str, float]:
    """One call of the chunked SSD scan over [batch, seq] with ``heads``
    heads of ``head_dim``, state size ``state`` and ``groups`` groups of
    B and C.  Operations, as the chunked algorithm needs them: within
    each chunk C B^T over its causal pairs (once a group) and their
    masked product with x (a head), each chunk's state from B x^T, the
    output from each chunk's starting state (C h), and the state carried
    from chunk to chunk (a multiply and an add an element).  Bytes: x, B,
    C in and y out in ``elem_bytes``, dt in float32 (one a head and
    position), each once."""
    pairs = chunk_pairs(seq, chunk)
    n_chunks = -(-seq // chunk)
    hnp = heads * state * head_dim
    ops = (2.0 * pairs * (groups * state + heads * head_dim) +
           4.0 * seq * hnp + 2.0 * n_chunks * hnp)
    elems = seq * (2 * heads * head_dim + 2 * groups * state)
    return {"flops": batch * ops,
            "bytes": float(batch * (elem_bytes * elems + 4 * seq * heads))}


def ssd_scan_of(model: Dict, batch: int, seq: int,
                elem_bytes: int) -> Dict[str, float]:
    """:func:`ssd_scan` at a configuration's Mamba2 sizes."""
    m = mamba_dims(model)
    return ssd_scan(batch, seq, m["heads"], m["head_dim"], m["state"],
                    m["groups"], m["chunk"], elem_bytes)


def prefill_flops(model: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill that returns the last position's
    logits: 2 x the matrix parameters a token meets x T (each Mamba2
    layer's ``in_proj`` and ``out_proj``, each attention layer's q, k,
    v, o, every layer's router, top-k experts and shared expert), each
    Mamba2 layer's SSD scan (:func:`ssd_scan`), each attention layer's
    causal pairs (4 B H D a pair), and the last token's unembedding."""
    d = int(model["hidden_size"])
    m, a = mamba_dims(model), flops.dims(model)
    kinds = list(model["layer_types"])
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    in_proj = d * (2 * m["d_inner"] + 2 * m["groups"] * m["state"] +
                   m["heads"])
    ffn = (a["top_k"] * 3 * d * a["ff"] + d * a["experts"] +
           3 * d * int(model["shared_intermediate_size"]))
    matrix = (n_mamba * (in_proj + m["d_inner"] * d) +
              n_attn * flops.attention_params(a) + len(kinds) * ffn)
    tokens = batch * seq
    return (2.0 * matrix * tokens +
            n_mamba * ssd_scan_of(model, batch, seq, 2)["flops"] +
            4.0 * batch * a["heads"] * a["head_dim"] *
            flops.causal_pairs(seq, seq) * n_attn +
            2.0 * d * a["vocab"] * batch)


#: the program's span around each call of its chunked scan
SCAN_SPAN = "chunked_linear_scan"


def scan_roofline(r) -> Optional[float]:
    """% of the scan's roofline in a traced run (a
    :class:`perfbench.harness.Reading`): the least time of every call
    under ``SCAN_SPAN`` in the traced steps (:func:`ssd_scan` at the
    step's batch and length) over the device time of the kernels they
    launched; None where the run gave nothing to read."""
    if r.trace is None or r.window is None or r.peaks is None:
        return None
    least = 0.0
    for s, (lo, hi) in zip(r.steps, r.step_spans):
        one = ssd_scan_of(r.model, s["batch"], s["seq"], r.elem_bytes)
        least += r.trace.span_count(SCAN_SPAN, lo, hi) * \
            flops.least_seconds(one, r.peaks)
    secs, count, _ = r.trace.under(SCAN_SPAN, *r.window)
    if count == 0 or secs <= 0.0:
        return None
    return 100.0 * least / secs
