"""Device microseconds of the kernels inside the program's ``moe_ffn``
spans, per prompt token."""
from perfbench.yardstick import readers


def read(r):
    return readers.span_us_per_token(r, "moe_ffn")
