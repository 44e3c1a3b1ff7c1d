"""Config registry: ``--arch <id>`` resolution for the ported archs.

The reference registers ten architectures; the port so far serves the
dense ``qwen2-1.5b``.  The other nine configs come with the model
families they need (ROADMAP Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import qwen2_1_5b
from repro_torch.configs.base import (ArchConfig, RunConfig, ShapeConfig,
                                      SHAPES, shape_applies)

__all__ = ["ARCH_IDS", "ArchConfig", "RunConfig", "SHAPES", "ShapeConfig",
           "get_config", "get_smoke_config", "shape_applies"]

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
}

ARCH_IDS = tuple(_MODULES.keys())


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"{arch_id!r} is not ported yet (ported: "
                       f"{', '.join(ARCH_IDS)}; see ROADMAP Queue 1)")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
