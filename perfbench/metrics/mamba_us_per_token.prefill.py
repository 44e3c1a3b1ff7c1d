"""Device microseconds of the kernels inside the program's `mamba2` spans
(each Mamba2 mixer, `in_proj` to `out_proj`), per prompt token."""
from perfbench.yardstick import readers


def read(r):
    return readers.span_us_per_token(r, "mamba2")
