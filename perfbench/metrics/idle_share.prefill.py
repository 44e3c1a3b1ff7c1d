"""% of the prefill window in which the device ran nothing, by the
traced block's device time."""
from perfbench.yardstick import readers


def read(r):
    return readers.idle_share(r)
