"""The prefill's model FLOPs (active parameters, attention, the last
token's unembedding) of the untraced window over its length, as a % of
the bf16 peak."""
from perfbench.yardstick import flops, readers


def read(r):
    return readers.mfu(r, flops.prefill_flops)
