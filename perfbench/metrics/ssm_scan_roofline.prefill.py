"""The chunked SSD scan in prefill as a % of its roofline: the larger of
its chunked-SSD FLOPs at the bf16 tensor-core peak and the bytes of x, B,
C, dt in and y out at the memory bandwidth, over the device time of the
kernels launched under `chunked_linear_scan`."""
from perfbench.yardstick import hybrid


def read(r):
    return hybrid.scan_roofline(r)
