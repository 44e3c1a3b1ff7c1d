"""Device microseconds of the kernels inside the program's `moe.dispatch`
spans (the gather of each expert's tokens and the padding mask), per prompt token."""
from perfbench.yardstick import readers


def read(r):
    return readers.span_us_per_token(r, "moe.dispatch")
