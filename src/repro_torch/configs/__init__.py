"""Config registry: ``--arch <id>`` resolution for all ten architectures
the reference registers (the port's copy of ``repro/configs``), and for
the architectures of the port alone (``PORT_ONLY``), which the JAX
package has no twin of and ``ARCH_IDS`` leaves out."""
from __future__ import annotations

from repro_torch.configs import (codeqwen1_5_7b, granite_4_0_h_small,
                                 granite_moe_1b, llama3_405b,
                                 phi3_5_moe_42b, pixtral_12b, qwen1_5_32b,
                                 qwen2_1_5b, seamless_m4t_large_v2,
                                 xlstm_350m, zamba2_1_2b)
from repro_torch.configs.base import (ArchConfig, RunConfig, ShapeConfig,
                                      SHAPES, shape_applies)

__all__ = ["ARCH_IDS", "ArchConfig", "PORT_ONLY", "RunConfig", "SHAPES",
           "ShapeConfig", "get_config", "get_smoke_config", "shape_applies"]

_MODULES = {
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "qwen1.5-32b": qwen1_5_32b,
    "qwen2-1.5b": qwen2_1_5b,
    "llama3-405b": llama3_405b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "xlstm-350m": xlstm_350m,
    "zamba2-1.2b": zamba2_1_2b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "pixtral-12b": pixtral_12b,
}

ARCH_IDS = tuple(_MODULES.keys())

_PORT_ONLY_MODULES = {
    "granite-4.0-h-small": granite_4_0_h_small,
}

PORT_ONLY = tuple(_PORT_ONLY_MODULES.keys())


def _module(arch_id: str):
    return _MODULES.get(arch_id) or _PORT_ONLY_MODULES[arch_id]


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
