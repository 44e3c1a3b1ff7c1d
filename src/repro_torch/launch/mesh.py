"""Meshes (the port of ``repro/launch/mesh.py``).

A :class:`Mesh` names its axes, their sizes and the devices it lies on,
one a rank in row-major order over the axes.  The sharding rules
(:mod:`repro_torch.parallel.sharding`) read the axis names and sizes.  A
mesh of several devices places tensors through
:meth:`Mesh.device_mesh`, a ``torch.distributed`` ``DeviceMesh`` with the
same axes, which needs an initialised process group of ``mesh.size``
ranks (``gloo`` on the CPU, one rank a card on CUDA); the caller starts
it (``torch.distributed.init_process_group`` with an address, the world
size and its rank).  The production meshes carry no devices: one host
has none of their 256 or 512 chips, so they are descriptions, and
placing a tensor on one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import runtime


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes, and the devices (row-major over the axes,
    one a rank; empty for a description of a mesh this host does not
    have)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()
    #: the DeviceMesh, built once by :meth:`device_mesh` (its process
    #: groups are made collectively, so every rank builds it once)
    _device_mesh: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

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

    def _check_process_group(self) -> None:
        if not self.devices:
            raise ValueError(
                f"the mesh {self.shape} is a description without devices: "
                f"placing tensors on it needs a process group of world "
                f"size {self.size}, one rank a device")
        if not dist.is_initialized() or \
                dist.get_world_size() != self.size:
            have = dist.get_world_size() if dist.is_initialized() else None
            raise RuntimeError(
                f"the mesh {self.shape} needs an initialised process group "
                f"of world size {self.size} (have {have})")

    @property
    def local_device(self) -> torch.device:
        """This rank's device (the only one of a one-device mesh)."""
        if self.trivial:
            if not self.devices:
                raise ValueError(f"the mesh {self.shape} has no device")
            return self.devices[0]
        self._check_process_group()
        return self.devices[dist.get_rank()]

    def device_mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` of these axes and
        sizes on the devices' type, built on the first call (a collective:
        every rank calls it) and kept.  Raises on a description or
        without a process group of world size :attr:`size`."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh
            self._check_process_group()
            dm = init_device_mesh(self.devices[0].type, self.sizes,
                                  mesh_dim_names=self.axis_names)
            object.__setattr__(self, "_device_mesh", dm)
        return self._device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 chips per pod; multi-pod adds a leading 'pod' axis (2 pods)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape: Tuple[int, ...],
              axes: Optional[Tuple[str, ...]] = None,
              devices: Union[None, str, Sequence] = None) -> Mesh:
    """Any mesh shape (tests, elastic re-meshing).  ``devices=None``
    makes a description; a device type makes the mesh the ranks of a
    process group share, one device a rank (``"cpu"``: every rank on its
    host's CPU, under ``gloo``; ``"cuda"``: rank ``i`` on ``cuda:i``); a
    sequence names each rank's device."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    mesh = Mesh(tuple(axes), tuple(shape))
    if devices is None:
        return mesh
    if isinstance(devices, str):
        kind = torch.device(devices).type
        devices = [torch.device(kind) if kind == "cpu" else
                   torch.device(kind, i) for i in range(mesh.size)]
    return Mesh(tuple(axes), tuple(shape),
                tuple(torch.device(d) for d in devices))


def host_mesh(device=None) -> Mesh:
    """``(1, 1)`` over ``("data", "model")`` on :func:`runtime.device`
    (``device`` overrides): the one card, or the CPU when asked for."""
    return Mesh(("data", "model"), (1, 1), (runtime.device(device),))
