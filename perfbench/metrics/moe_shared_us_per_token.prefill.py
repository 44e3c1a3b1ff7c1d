"""Device microseconds of the kernels inside the program's `moe.shared`
spans (the shared expert beside the routed ones), per prompt token."""
from perfbench.yardstick import readers


def read(r):
    return readers.span_us_per_token(r, "moe.shared")
