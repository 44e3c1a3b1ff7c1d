"""Device selection for the port (twin of the reference's
``repro/kernels/runtime.py``, which picks the Pallas interpreter or
Mosaic).

Every entry point of :mod:`repro_torch` runs on ``cuda`` unless the caller
asks for the CPU, either per call (an explicit ``device="cpu"`` where an
entry point takes one) or for the process (:func:`set_device` /
:func:`use_device`, which is what the CPU tests do).  With no GPU and no
explicit CPU request :func:`device` raises: the port never quietly runs
its plain versions on the CPU in place of its kernels.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device]

_LOCK = threading.Lock()
_CHOSEN: Optional[torch.device] = None


class NoDeviceError(RuntimeError):
    """No CUDA device is present and the caller did not ask for the CPU."""


def set_device(dev: Optional[DeviceLike]) -> None:
    """Pin the process-wide default device (``None`` restores the
    default, ``cuda``)."""
    global _CHOSEN
    with _LOCK:
        _CHOSEN = None if dev is None else torch.device(dev)


@contextlib.contextmanager
def use_device(dev: Optional[DeviceLike]) -> Iterator[torch.device]:
    """:func:`set_device` for the duration of a ``with`` block."""
    global _CHOSEN
    with _LOCK:
        previous = _CHOSEN
        _CHOSEN = None if dev is None else torch.device(dev)
    try:
        yield device()
    finally:
        with _LOCK:
            _CHOSEN = previous


def device(explicit: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on.

    ``explicit`` wins, then the process default from :func:`set_device`,
    then ``cuda``.  Raises :class:`NoDeviceError` when that resolves to
    CUDA on a machine without it."""
    dev = torch.device(explicit) if explicit is not None else _CHOSEN
    if dev is None:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "present; pass device='cpu' or call "
            "repro_torch.runtime.set_device('cpu') to run the plain "
            "PyTorch versions on the CPU")
    return dev
