"""Device milliseconds a training step of the kernels launched under the
program's `train.loss` span (the chunked cross-entropy's forward)."""
from perfbench.yardstick import phases


def read(r):
    return phases.phase_ms(r, "train.loss")
