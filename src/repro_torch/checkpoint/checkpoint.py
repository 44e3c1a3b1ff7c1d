"""Step-atomic checkpointing with an async writer (the port of
``repro/checkpoint/checkpoint.py``).

Layout:  <dir>/step_<n>/{manifest.json, arrays.npz}, as the reference's.
A checkpoint is only visible once its directory is renamed into place with
the manifest inside (written last), so a crash mid-write never corrupts
restore.  Keys are the tree's paths in the reference's spelling: a
NamedTuple field ``.params``, a dict key as it is, a list or tuple index
``[i]``.  numpy has no bfloat16, so a bf16 tensor is stored as its 16-bit
pattern and the manifest's ``dtypes`` names it ``bfloat16``; restore
gives it back bit for bit.  Restore puts every tensor on an explicit
device.  A tree of DTensors (a state on a mesh of several devices) is
gathered whole on every rank, since the gather is a collective, and only
rank 0 writes; restore places each leaf on a mesh by its spec, which may
be another mesh than the one saved from (the elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import runtime
from repro_torch.parallel.sharding import place

Params = Any
_SEP = "/"


def _items(tree: Params, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf of a tree of NamedTuples, dicts, lists
    and tuples, in order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (f"[{i}]",))
    else:
        yield _SEP.join(prefix), tree


def _unflatten(template: Params, leaves: Iterator[Any]) -> Params:
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process
    group, or a process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _snapshot(tree: Params) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copies of the tree's tensors as numpy (bf16 as its int16
    bits) and their dtypes' names; copying a CUDA tensor waits for the
    work that writes it.  A DTensor leaf is gathered whole first, on
    every rank (a collective); only the writer keeps the copies."""
    arrays, dtypes = {}, {}
    for key, leaf in _items(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if not _writer():
            continue
        t = leaf.detach().to("cpu", copy=True)
        dtypes[key] = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arrays[key] = t.numpy()
    return arrays, dtypes


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray],
           dtypes: Dict[str, str], extra: Optional[Dict]) -> str:
    step_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    np.savez(os.path.join(tmp_dir, "arrays.npz"), **arrays)
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(arrays),
                "shapes": {k: list(v.shape) for k, v in arrays.items()},
                "dtypes": dtypes, "extra": extra or {}}
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)  # atomic publish
    return step_dir


def save_checkpoint(directory: str, step: int, tree: Params,
                    extra: Optional[Dict] = None) -> str:
    """Synchronous step-atomic save of ``tree`` (tensors on any device,
    or DTensors: every rank calls it, rank 0 writes)."""
    arrays, dtypes = _snapshot(tree)
    step_dir = os.path.join(directory, f"step_{step:08d}")
    if _writer():
        _write(directory, step, arrays, dtypes, extra)
    return step_dir


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name,
                                            "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Params,
                       step: Optional[int] = None, device=None,
                       shardings: Optional[Params] = None, mesh=None
                       ) -> Tuple[int, Params]:
    """Restore into the structure of ``template`` (tensors, the meta
    device's too, give the structure, shapes and dtypes) on ``device``
    (default: :func:`repro_torch.runtime.device`; with ``mesh``, this
    rank's device of it).  A stored dtype that differs from the
    template's (a reference checkpoint keeps bf16 as float32) is cast to
    the template's.  With ``shardings`` (specs in the template's
    structure) and a ``mesh`` of several devices every leaf is placed on
    it as a DTensor: every rank reads the whole checkpoint and keeps its
    shard, whatever mesh saved it."""
    if shardings is not None and mesh is None:
        raise ValueError("shardings= needs the mesh to place them on")
    dev = mesh.local_device if mesh is not None and device is None else \
        runtime.device(device)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as fh:
        dtypes = json.load(fh)["dtypes"]
    leaves: List[torch.Tensor] = []
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        for key, leaf in _items(template):
            t = torch.from_numpy(data[key])
            if dtypes[key] == "bfloat16" and t.dtype == torch.int16:
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: stored shape {tuple(t.shape)}, "
                                 f"template {tuple(leaf.shape)}")
            leaves.append(t.to(device=dev, dtype=leaf.dtype))
    tree = _unflatten(template, iter(leaves))
    if shardings is not None and not mesh.trivial:
        tree = place(tree, shardings, mesh)
    return step, tree


class CheckpointManager:
    """Async checkpointing: copy to the host on the caller's thread, write
    in a background thread.

    Keeps the last ``keep`` checkpoints; ``wait()`` drains pending writes
    (call before process exit).  A failed async write surfaces on the next
    ``save``/``wait`` call rather than being silently dropped.  In a
    process group every rank calls ``save`` (a DTensor state is gathered
    collectively) and rank 0 alone writes.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Params,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        arrays, dtypes = _snapshot(tree)   # before the caller moves on
        if not _writer():
            return

        def write():
            try:
                _write(self.directory, step, arrays, dtypes, extra)
                self._gc()
            except BaseException as exc:  # surfaced on next call
                self._error = exc

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from error

    def _gc(self) -> None:
        steps = sorted(s for s in (
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")))
        for old in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"step_{old:08d}"),
                          ignore_errors=True)
