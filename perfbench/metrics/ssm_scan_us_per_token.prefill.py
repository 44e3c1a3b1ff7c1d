"""Device microseconds of the kernels inside the program's
`chunked_linear_scan` spans (the Mamba2 layers' SSD scan), per prompt
token."""
from perfbench.yardstick import hybrid, readers


def read(r):
    return readers.span_us_per_token(r, hybrid.SCAN_SPAN)
