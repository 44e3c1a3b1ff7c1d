"""Device milliseconds a training step of the kernels launched under the
program's `train.forward` span (the model's forward, remat'd blocks'
first pass)."""
from perfbench.yardstick import phases


def read(r):
    return phases.phase_ms(r, "train.forward")
