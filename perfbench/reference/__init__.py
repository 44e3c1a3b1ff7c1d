"""The plain reference: float32 PyTorch with no kernel, cache or batching
of the program's, and nothing imported from it."""
