"""Hand-written Hopper kernels of the port and their launch counters.

Each kernel wrapper owns one :class:`LaunchCounter` and adds one to it
exactly where it launches its kernel on a CUDA tensor — never on the plain
PyTorch path the wrapper takes for CPU tensors.  A run can therefore show
that a code path really went through the kernels: reset the counters,
drive the path, read :func:`launch_counts`.  They count whether or not
a profiler records; the program's spans and tallies, which count only
while one does, are in :mod:`repro_torch.tracing`.  The kernels have no
backward: a model calls one only where :func:`records_grad` is false.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch


class LaunchCounter:
    """A thread-safe count of one kernel's launches."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._count = 0
        self._lock = threading.Lock()

    def hit(self) -> None:
        with self._lock:
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self) -> None:
        with self._lock:
            self._count = 0


_REGISTRY_LOCK = threading.Lock()
_COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    """The process-wide counter of kernel ``name`` (created on first use)."""
    with _REGISTRY_LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = LaunchCounter(name)
        return c


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    with _REGISTRY_LOCK:
        counters = list(_COUNTERS.values())
    return {c.name: c.count for c in counters}


def reset_launch_counts() -> None:
    with _REGISTRY_LOCK:
        counters = list(_COUNTERS.values())
    for c in counters:
        c.reset()


def records_grad(*xs: torch.Tensor) -> bool:
    """Whether autograd records an op on ``xs`` now: the hand-written
    kernels, which have no backward, run only where it does not."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)
