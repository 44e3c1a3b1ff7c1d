"""Device microseconds of the kernels inside the program's `moe.experts`
spans (the three expert products and silu(gate) x up), per prompt token."""
from perfbench.yardstick import readers


def read(r):
    return readers.span_us_per_token(r, "moe.experts")
