"""Cost-learning module (paper Fig. 4): benchmark -> fit -> profile.

The port's twin of the reference's ``core/training.py``.  Every Level-2
primitive's micro-benchmark runs over its size grid on this machine's host
(numpy, :mod:`repro_torch.core.access`), the designated model family is
fitted on the runtime device (:func:`repro_torch.core.models.fit`), and
the fits are assembled into a :class:`HardwareProfile` whose JSON the
reference reads too.  This is the paper's offline "training" pass — "it
takes merely a few minutes" (Fig. 7b) — kept that cheap by bounding reps
per size.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch import runtime
from repro_torch.core import access
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.models import FittedModel, fit, r2_score


def benchmark_primitive(prim: access.Level2Primitive,
                        sizes: Optional[Iterable[int]] = None,
                        reps: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Collect (X, Y): size grid vs measured seconds-per-op (Fig. 4 step 1-2)."""
    xs, ys = [], []
    for n in (sizes or prim.sizes):
        # fewer reps on big inputs keeps total training time bounded
        n_reps = max(int(reps / max(np.log2(n) - 6, 1)), 4)
        ys.append(prim.benchmark(int(n), n_reps))
        xs.append(float(n))
    return np.asarray(xs, np.float64), np.asarray(ys, np.float64)


def train_profile(name: str = "HW-container",
                  primitives: Optional[Iterable[str]] = None,
                  reps: int = 64,
                  max_size: Optional[int] = None,
                  device: Optional[runtime.DeviceLike] = None,
                  measurements: Optional[Dict[str, Tuple[np.ndarray,
                                                         np.ndarray]]] = None,
                  records: Optional[Dict[str, dict]] = None
                  ) -> HardwareProfile:
    """Train all (or selected) Level-2 primitives on this machine, the
    fits on ``device`` (the runtime device by default).  Besides the
    reference's constants (``training_seconds``, ``r2_<primitive>``) the
    profile records each fit's seconds (``fit_seconds_<primitive>``) and
    their sum (``fitting_seconds``).  A ``measurements`` dict, if given,
    receives each primitive's measured ``(x, y)``; a ``records`` dict
    each fit's Adam trajectory (``models.fit(..., record=)``, for
    ``models.replay_gap``)."""
    dev = runtime.device(device)
    models: Dict[str, FittedModel] = {}
    fit_quality: Dict[str, float] = {}
    fit_seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    names = list(primitives or access.LEVEL2.keys())
    for pname in names:
        prim = access.LEVEL2[pname]
        sizes = [s for s in prim.sizes if max_size is None or s <= max_size]
        x, y = benchmark_primitive(prim, sizes=sizes, reps=reps)
        if measurements is not None:
            measurements[pname] = (x, y)
        t_fit = time.perf_counter()
        record = None if records is None else records.setdefault(pname, {})
        model = fit(prim.model_kind, x, y, device=dev,   # synchronizes
                    record=record)
        fit_seconds[pname] = time.perf_counter() - t_fit
        pred = model.predict(x, dev)
        fit_quality[pname] = r2_score(y, pred)
        models[pname] = model
    train_s = time.perf_counter() - t0
    constants = {"training_seconds": train_s,
                 "fitting_seconds": sum(fit_seconds.values())}
    constants.update({f"r2_{k}": v for k, v in fit_quality.items()})
    constants.update({f"fit_seconds_{k}": v for k, v in fit_seconds.items()})
    return HardwareProfile(name, models, constants=constants)


def quick_profile(name: str = "HW-container-quick",
                  device: Optional[runtime.DeviceLike] = None
                  ) -> HardwareProfile:
    """Reduced grid used by tests: trains in a few seconds."""
    dev = runtime.device(device)
    models: Dict[str, FittedModel] = {}
    for pname, prim in access.LEVEL2.items():
        sizes = prim.sizes[:5]
        x, y = benchmark_primitive(prim, sizes=sizes, reps=16)
        models[pname] = fit(prim.model_kind, x, y, device=dev)
    return HardwareProfile(name, models)
