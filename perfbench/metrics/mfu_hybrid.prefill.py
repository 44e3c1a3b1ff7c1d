"""A hybrid model's prefill FLOPs (Mamba2 and attention projections, the
SSD scan, routed and shared experts, the router, causal attention pairs,
the last token's unembedding) of the untraced window over its length, as
a % of the bf16 peak."""
from perfbench.yardstick import hybrid, readers


def read(r):
    return readers.mfu(r, hybrid.prefill_flops)
