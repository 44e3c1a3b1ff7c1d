"""The Mamba2 SSD scan as a chunked Triton kernel (one group of B and C)."""
