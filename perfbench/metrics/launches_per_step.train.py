"""Kernels launched a training step (the host's dispatch of the step)."""
from perfbench.yardstick import readers


def read(r):
    return readers.launches_per_step(r)
