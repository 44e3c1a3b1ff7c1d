"""The LM model stack of the port (dense family so far)."""
from repro_torch.models.registry import Model, build

__all__ = ["Model", "build"]
