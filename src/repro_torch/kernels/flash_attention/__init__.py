"""Kernel K5: online-softmax (flash) attention forward, GQA and causal."""
