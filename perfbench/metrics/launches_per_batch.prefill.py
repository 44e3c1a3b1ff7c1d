"""Kernels launched a prefill batch (the host's dispatch of a prefill)."""
from perfbench.yardstick import readers


def read(r):
    return readers.launches_per_step(r)
