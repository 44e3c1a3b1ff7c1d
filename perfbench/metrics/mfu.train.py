"""The training steps' model FLOPs (frozen ``train_flops``) of the
untraced window over its length, as a % of the card's bf16 peak."""
from perfbench.yardstick import flops, readers


def read(r):
    return readers.mfu(r, flops.train_flops)
