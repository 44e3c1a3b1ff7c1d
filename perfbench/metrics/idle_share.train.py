"""% of the training window in which the device ran nothing, by the
traced steps' device time."""
from perfbench.yardstick import readers


def read(r):
    return readers.idle_share(r)
