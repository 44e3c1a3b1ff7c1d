"""Hardware profiles (paper §3 "hardware and data profiles").

The port's twin of the reference's ``core/hardware.py``: the same JSON
schema (:meth:`HardwareProfile.save` / :meth:`HardwareProfile.load`), the
analytical profiles ``hw1``..``hw3``, and :func:`profile_from_arrays`,
which turns fitted parameters held as numpy arrays (e.g. a profile the
reference trained) into a port profile without a JSON round trip.  Also
the accelerator peaks :mod:`repro_torch.core.distcalc` reads:
:class:`TPUProfile`, the reference's ``TPU_V5E`` and the card's
``H100_SXM``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.models import FittedModel


@dataclasses.dataclass
class HardwareProfile:
    """Container for fitted Level-2 models plus descriptive constants."""

    name: str
    models: Dict[str, FittedModel]
    constants: Dict[str, float] = dataclasses.field(default_factory=dict)
    key_bytes: int = 8
    value_bytes: int = 8
    #: lazily-built device-resident parameter banks for the fused frontier
    #: scorer (:func:`repro_torch.core.devicecost.device_table`); excluded
    #: from eq/repr and never persisted — what-if hardware questions swap
    #: this table into an already-built scorer with zero new kernel
    #: specialisations.  ``init=False`` so ``dataclasses.replace``-derived
    #: profiles never inherit another model zoo's banks (devicecost
    #: re-checks the models identity anyway before trusting a cached table)
    _device_table: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def model(self, level2_name: str) -> FittedModel:
        return self.models[level2_name]

    def save(self, path: str) -> None:
        obj = {"name": self.name, "constants": self.constants,
               "key_bytes": self.key_bytes, "value_bytes": self.value_bytes,
               "models": {k: m.to_json() for k, m in self.models.items()}}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(obj, fh)

    @staticmethod
    def load(path: str) -> "HardwareProfile":
        with open(path) as fh:
            obj = json.load(fh)
        return HardwareProfile(
            name=obj["name"],
            models={k: FittedModel.from_json(v)
                    for k, v in obj["models"].items()},
            constants=obj.get("constants", {}),
            key_bytes=obj.get("key_bytes", 8),
            value_bytes=obj.get("value_bytes", 8))


def analytical_profile(name: str = "HW-analytical", *,
                       cpu_ns_per_cmp: float = 1.0,
                       l1_bytes: int = 32 << 10,
                       l2_bytes: int = 256 << 10,
                       l3_bytes: int = 16 << 20,
                       l1_ns: float = 1.5, l2_ns: float = 5.0,
                       l3_ns: float = 20.0, mem_ns: float = 90.0,
                       bw_bytes_per_s: float = 20e9) -> HardwareProfile:
    """Build a profile from first-principles constants (no benchmarks).

    The paper's models start out analytical before being trained; this
    constructor realizes that starting point and also lets us pose what-if
    questions about hypothetical machines (e.g. 2x memory bandwidth).
    """
    def sigmoid_cache_model(per_elem_bytes: float) -> FittedModel:
        # steps at each cache boundary, measured against region size in slots
        c = np.array([l2_ns - l1_ns, l3_ns - l2_ns, mem_ns - l3_ns],
                     dtype=np.float32) * 1e-9
        x0 = np.log(np.array([l1_bytes, l2_bytes, l3_bytes]) /
                    per_elem_bytes).astype(np.float32)
        return FittedModel("sigmoids", {
            "c": c, "k": np.full(3, 8.0, np.float32), "x0": x0,
            "y0": np.asarray(l1_ns * 1e-9, np.float32)},
            (1.0, 1e12))

    ns = 1e-9
    scan = FittedModel("linear", {
        "w": np.asarray([cpu_ns_per_cmp * ns], np.float32),
        "y0": np.asarray(5 * ns, np.float32)}, (1.0, 1e12))
    write = FittedModel("linear", {
        "w": np.asarray([16.0 / bw_bytes_per_s], np.float32),
        "y0": np.asarray(10 * ns, np.float32)}, (1.0, 1e12))
    bsearch = FittedModel("log_linear", {
        "w": np.asarray([0.0, (mem_ns / 3 + cpu_ns_per_cmp) * ns], np.float32),
        "y0": np.asarray(5 * ns, np.float32)}, (1.0, 1e12))
    isearch = FittedModel("log_loglog", {
        "w": np.asarray([0.0, 2 * cpu_ns_per_cmp * ns,
                         mem_ns / 2 * ns], np.float32),
        "y0": np.asarray(5 * ns, np.float32)}, (1.0, 1e12))
    sort = FittedModel("nlogn", {
        "w": np.asarray([cpu_ns_per_cmp * ns, 2 * cpu_ns_per_cmp * ns],
                        np.float32),
        "y0": np.asarray(20 * ns, np.float32)}, (1.0, 1e12))
    ra = sigmoid_cache_model(8.0)
    models = {
        "scalar_scan_rowstore_equal": scan,
        "scalar_scan_columnstore_equal": scan,
        "scalar_scan_columnstore_range": scan,
        "binary_search_rowstore": bsearch,
        "binary_search_columnstore": bsearch,
        "interpolation_search_columnstore": isearch,
        "hash_probe_multiply_shift": ra,
        "bloom_probe_multiply_shift": ra,
        "quicksort": sort,
        "random_memory_access": ra,
        "batched_random_memory_access": sigmoid_cache_model(64.0),
        "serial_write": write,
        "ordered_batch_write": write,
        "scattered_batch_write": ra,
    }
    return HardwareProfile(name, models, constants=dict(
        l1_bytes=l1_bytes, l2_bytes=l2_bytes, l3_bytes=l3_bytes,
        mem_ns=mem_ns, bw_bytes_per_s=bw_bytes_per_s))


# Three reference machines in the spirit of the paper's HW1..HW3 grid, used
# by the what-if benchmarks (Fig. 6 rows / §5 design questions).
def hw1() -> HardwareProfile:
    return analytical_profile("HW1", mem_ns=90.0, l3_bytes=16 << 20,
                              bw_bytes_per_s=20e9)


def hw2() -> HardwareProfile:
    return analytical_profile("HW2", mem_ns=120.0, l3_bytes=8 << 20,
                              cpu_ns_per_cmp=1.5, bw_bytes_per_s=12e9)


def hw3() -> HardwareProfile:
    return analytical_profile("HW3", mem_ns=70.0, l3_bytes=32 << 20,
                              cpu_ns_per_cmp=0.7, bw_bytes_per_s=40e9)


# ---------------------------------------------------------------------------
# Accelerator constants (the distributed Data Calculator, core/distcalc.py)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TPUProfile:
    """One accelerator chip's peaks, as :mod:`repro_torch.core.distcalc`
    reads them (the reference's class, kept under its name so that
    ``distcalc`` is the same function in both packages).

    ``distcalc`` reads ``peak_flops_bf16``, ``hbm_bw``, ``hbm_bytes`` and
    ``ici_bw``.  ``ici_links_per_axis``, ``vmem_bytes`` and ``mxu_tile``
    describe a TPU (links of its torus, its vector memory, its matrix
    unit's tile); nothing in the port reads them."""

    name: str = "tpu_v5e"
    peak_flops_bf16: float = 197e12     # per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    hbm_bytes: float = 16e9             # per chip
    ici_bw: float = 50e9                # bytes/s per link per direction
    ici_links_per_axis: int = 1         # 2D torus: 1 link per mesh direction
    vmem_bytes: float = 128e6
    mxu_tile: int = 128

    def compute_seconds(self, flops_per_chip: float) -> float:
        return flops_per_chip / self.peak_flops_bf16

    def memory_seconds(self, bytes_per_chip: float) -> float:
        return bytes_per_chip / self.hbm_bw

    def collective_seconds(self, bytes_per_chip: float) -> float:
        return bytes_per_chip / self.ici_bw


#: the reference's TPU v5e figures, verbatim (reference data: the default
#: of every ``distcalc`` function, as in the reference)
TPU_V5E = TPUProfile()

#: one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU datasheet, SXM part,
#: dense rates): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3,
#: 80 GB.  ``ici_bw`` is NVLink 4 in one direction: the datasheet's 900
#: GB/s a GPU counts both directions, so 450e9 B/s each way.  The
#: TPU-only fields are 0: the card has no torus links, vector memory or
#: MXU, and nothing reads them.
H100_SXM = TPUProfile(name="h100_sxm", peak_flops_bf16=989e12,
                      hbm_bw=3.35e12, hbm_bytes=80e9, ici_bw=450e9,
                      ici_links_per_axis=0, vmem_bytes=0.0, mxu_tile=0)


def profile_from_arrays(name: str,
                        fitted: Dict[str, Tuple[str, Dict[str, np.ndarray],
                                                Tuple[float, float]]],
                        constants: Optional[Dict[str, float]] = None,
                        key_bytes: int = 8,
                        value_bytes: int = 8) -> HardwareProfile:
    """A port profile from ``{level2: (kind, params, x_range)}``.

    ``params`` maps parameter names to numpy arrays exactly as a fitted
    model holds them (``w``/``y0``, ``c``/``k``/``x0``/``y0``,
    ``s1_*``/``s2_*``, ``x``/``y``); they are stored as float32, as
    :meth:`FittedModel.from_json` stores them."""
    models = {
        level2: FittedModel(kind, {k: np.asarray(v, dtype=np.float32)
                                   for k, v in params.items()},
                            (float(x_range[0]), float(x_range[1])))
        for level2, (kind, params, x_range) in fitted.items()}
    return HardwareProfile(name, models, constants=dict(constants or {}),
                           key_bytes=key_bytes, value_bytes=value_bytes)
