"""Device milliseconds a training step of the kernels launched under the
program's `train.adamw` span (AdamW's moments and the update's
application)."""
from perfbench.yardstick import phases


def read(r):
    return phases.phase_ms(r, "train.adamw")
