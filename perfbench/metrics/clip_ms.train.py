"""Device milliseconds a training step of the kernels launched under the
program's `train.clip` span (the global-norm gradient clip)."""
from perfbench.yardstick import phases


def read(r):
    return phases.phase_ms(r, "train.clip")
