"""Device microseconds of the kernels inside the program's `moe.route`
spans (the router product, softmax, both top-k's and the mask), per prompt token."""
from perfbench.yardstick import readers


def read(r):
    return readers.span_us_per_token(r, "moe.route")
