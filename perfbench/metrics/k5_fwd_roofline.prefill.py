"""K5's forward in prefill as a % of its roofline."""
from perfbench.yardstick import flops, readers


def read(r):
    return readers.roofline(r, readers.K5_FWD_OP, flops.k5_fwd)
