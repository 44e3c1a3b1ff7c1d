"""Kernels a training step launched under the program's `train.clip`
and `train.adamw` spans (the optimizer's share of the step's dispatch)."""
from perfbench.yardstick import phases


def read(r):
    return phases.phase_launches(r, ["train.clip", "train.adamw"])
