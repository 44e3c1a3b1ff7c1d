"""Mesh descriptions (the port of ``repro/launch/mesh.py``).

A :class:`Mesh` names its axes, their sizes and the devices it lies on.
It is a description only: nothing here initialises ``torch.distributed``.
The sharding rules (:mod:`repro_torch.parallel.sharding`) read the axis
names and sizes; the production meshes carry no devices, since one host
has none of their 256 or 512 chips, and placing tensors on a mesh of
several devices waits for DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import runtime


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes, and the devices (row-major over the axes;
    empty for a description of a mesh this host does not have)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def trivial(self) -> bool:
        """Every axis has size 1: a spec over it places nothing."""
        return self.size == 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 chips per pod; multi-pod adds a leading 'pod' axis (2 pods)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape: Tuple[int, ...],
              axes: Optional[Tuple[str, ...]] = None) -> Mesh:
    """Any mesh shape (tests, elastic re-meshing), as a description."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(tuple(axes), tuple(shape))


def host_mesh(device=None) -> Mesh:
    """``(1, 1)`` over ``("data", "model")`` on :func:`runtime.device`
    (``device`` overrides): the one card, or the CPU when asked for."""
    return Mesh(("data", "model"), (1, 1), (runtime.device(device),))
