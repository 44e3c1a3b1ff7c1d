"""One driver a kind of traffic (``perfbench/traffic/<mix>.json``'s
``kind``): ``run(cell, device, seed, seconds, trace, t0)``."""
