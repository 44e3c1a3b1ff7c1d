"""The Data Calculator core, ported to PyTorch: Level-2 cost models,
hardware profiles, the scalar expert system, template-vectorized packing,
the grouped and fused engines, what-if questions and auto-completion."""
