"""Prefill serving of a model that the plain decoder of ``decoder.py`` does
not describe: the closed loop, the window, the trace and the sample of
checked batches of ``prefill.py``, run by ``prefill.run`` itself, with the
reference the configuration's ``reference`` key names in place of
``decoder.Decoder``.

The reference's module (``perfbench/reference/<name>.py``) names as
``Model`` a class that takes the configuration's ``model`` and a
``decoder.Matmul`` and gives ``last_logits(W, tokens)``; it is given the
weights as drawn (bf16, the router float32) and casts each layer to
float32 only while it runs it, since a model the size of the card's
memory in bf16 does not fit in it in float32.
"""
from __future__ import annotations

import contextlib
import importlib
from pathlib import PurePosixPath
from typing import Dict, List

from perfbench.drivers import common, prefill
from perfbench.reference import decoder
from perfbench.yardstick import compare, weights


def reference_class(cell):
    """The ``Model`` class of the module the configuration's
    ``reference`` names."""
    path = PurePosixPath(cell.config["reference"]).with_suffix("")
    return importlib.import_module(".".join(path.parts)).Model


def reference_gaps(cell, spec, seed: int, dev, served, picked,
                   precision: str = "float32") -> Dict[int, List[float]]:
    """``prefill.reference_gaps`` with the configuration's reference on
    the weights as drawn."""
    import torch
    model = reference_class(cell)
    W = weights.draw(spec, cell.config["init"], seed, dev)
    ref = model(cell.config["model"])
    low = model(cell.config["model"], decoder.Matmul(precision))
    gaps = {}
    with decoder.exact_float32():
        for j in picked:
            length, tokens = served[j]
            p = torch.as_tensor(prefill.prompts(cell, seed, j, length),
                                device=dev)
            logits = ref.last_logits(W, p)
            if precision != "float32":
                tokens = low.last_logits(W, p).argmax(-1)
            gaps[j] = compare.logit_gaps(logits, tokens)
            del logits
    del W
    common.free_device()
    return gaps


@contextlib.contextmanager
def this_reference():
    """``prefill.py``'s functions with :func:`reference_gaps` in place of
    its own, so that the window, the trace and the check are prefill.py's
    to the letter."""
    own = prefill.reference_gaps
    prefill.reference_gaps = reference_gaps
    try:
        yield
    finally:
        prefill.reference_gaps = own


def run(cell, dev, seed: int, seconds: float, trace: bool, t0: float
        ) -> Dict:
    with this_reference():
        return prefill.run(cell, dev, seed, seconds, trace, t0)
