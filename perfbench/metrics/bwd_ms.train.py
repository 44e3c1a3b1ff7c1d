"""Device milliseconds a training step of the kernels launched under the
program's `train.backward` span on any thread (the autograd engine's
device thread included): the gradient with the remat'd blocks' and CE
slices' recompute."""
from perfbench.yardstick import phases


def read(r):
    return phases.phase_ms(r, "train.backward")
