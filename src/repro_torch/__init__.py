"""PyTorch/CUDA port of the Data Calculator (reference: ``src/repro``).

The package mirrors the reference's module paths.  It imports torch,
numpy and the standard library only — never JAX and nothing of the
reference package.  Entry points run on CUDA unless the caller asks for
the CPU (:mod:`repro_torch.runtime`); the hand-written Hopper kernels
live beside their plain PyTorch versions (:mod:`repro_torch.kernels`,
:mod:`repro_torch.core.devicecost`).
"""
