"""K5's backward in training as a % of its roofline."""
from perfbench.yardstick import flops, readers


def read(r):
    return readers.roofline(r, readers.K5_BWD_OP, flops.k5_bwd)
