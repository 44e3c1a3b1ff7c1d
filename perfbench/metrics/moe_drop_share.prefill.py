"""% of the MoE layers' token-expert assignments that no capacity slot
took, by the program's tallies over the traced batches and the warm
batch that starts the profiler: 100 (1 - moe.kept / moe.assigned)."""
from perfbench.yardstick import phases


def read(r):
    counts = phases.moe_counts()
    if counts is None:
        return None
    assigned, kept = counts
    return 100.0 * (1.0 - kept / assigned)
