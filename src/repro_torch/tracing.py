"""The port's spans and tallies, in one place.

Spans.  :func:`span` opens a ``torch.profiler.record_function`` range
while a profiler records (``torch.profiler.profile``, or the autograd
profiler), and a shared no-op context otherwise: a bare
``record_function`` enters the profiler's op even when nothing records,
a check of the profiler's flag costs a fraction of that.  The ranges land
in the same trace as the device activity, so a reader of the trace can
give each kernel to the span whose host call launched it.

Tallies.  :func:`tally` adds to a process-wide count, only while a
profiler records: a Python int on the host, or a 0-d tensor kept as it
is on its device (no kernel, no host sync).  :func:`tallies` reads them
all, :func:`reset_tallies` clears them.

The kernels' launch counters, which count whether or not a profiler
records, are in :mod:`repro_torch.kernels`.

Spans and tallies of the program (name: where):

* ``train.forward``, ``train.loss``, ``train.backward``, ``train.clip``,
  ``train.adamw``: the phases of ``train/loop.py``'s step, siblings.
* ``moe_ffn`` and, inside it, ``moe.route``, ``moe.dispatch``,
  ``moe.experts``, ``moe.combine``: ``models/moe.py``; tallies
  ``moe.assigned`` (token-expert assignments) and ``moe.kept``
  (assignments a capacity slot took).
* ``chunked_linear_scan``, ``slstm_scan``: ``models/ssm.py``.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Dict, List, Tuple, Union

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records now."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function`` range called ``name`` while a profiler
    records, else a no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


_TALLY_LOCK = threading.Lock()
_HOST_TALLIES: Dict[str, int] = {}
#: (name, device) -> the 0-d tensors tallied there, summed when read
_DEVICE_TALLIES: Dict[Tuple[str, torch.device], List[torch.Tensor]] = {}


def tally(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` to the tally ``name`` while a profiler records.  A
    tensor (0-d, a DTensor's local part) is kept, detached, until
    :func:`tallies` sums it: the call launches nothing."""
    if not _profiler._is_profiler_enabled:
        return
    if not isinstance(value, torch.Tensor):
        with _TALLY_LOCK:
            _HOST_TALLIES[name] = _HOST_TALLIES.get(name, 0) + int(value)
        return
    to_local = getattr(value, "to_local", None)
    value = (to_local() if to_local is not None else value).detach()
    with _TALLY_LOCK:
        _DEVICE_TALLIES.setdefault((name, value.device), []).append(value)


def tallies() -> Dict[str, int]:
    """Every tally since the last :func:`reset_tallies`, summed over
    devices in float64: one host sync a device."""
    with _TALLY_LOCK:
        out = dict(_HOST_TALLIES)
        device = list(_DEVICE_TALLIES.items())
    by_device = defaultdict(list)
    for (name, dev), values in device:
        by_device[dev].append((name, values))
    for items in by_device.values():
        sums = torch.stack([
            torch.stack([v.to(torch.float64) for v in values]).sum()
            for _, values in items]).tolist()
        for (name, _), v in zip(items, sums):
            out[name] = out.get(name, 0) + int(round(v))
    return out


def reset_tallies() -> None:
    with _TALLY_LOCK:
        _HOST_TALLIES.clear()
        _DEVICE_TALLIES.clear()
