"""The LM model stack of the port: every family of the reference."""
from repro_torch.models.registry import Model, build

__all__ = ["Model", "build"]
