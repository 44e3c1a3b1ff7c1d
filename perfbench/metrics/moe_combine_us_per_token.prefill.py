"""Device microseconds of the kernels inside the program's `moe.combine`
spans (the gate gather, the weighting and index_add_), per prompt token."""
from perfbench.yardstick import readers


def read(r):
    return readers.span_us_per_token(r, "moe.combine")
