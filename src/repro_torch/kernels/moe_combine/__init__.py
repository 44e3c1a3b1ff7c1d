"""The MoE combine as a gather: each token sums its kept expert rows."""
