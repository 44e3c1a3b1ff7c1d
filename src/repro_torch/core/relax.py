"""Continuous relaxation of design knobs for gradient-guided search.

The port's twin of the reference's ``core/relax.py``.  The fused engine
(:mod:`repro_torch.core.devicecost`) scores designs through
*differentiable* parameter banks — the linear-basis and sigmoid Level-2
model families are smooth in their size argument.  This module exploits
that: a discrete element chain is re-parameterized as a
:class:`RelaxedDesign` — a structural :class:`RelaxTemplate` (which
element class sits at each level) plus a continuous knob vector ``theta``
in log2 space (per-level fanout / partition count, terminal capacity,
optional bloom bits) — and a smooth surrogate of the chain's per-query
cost is evaluated against the profile's *real* bank rows via the plain
:func:`repro_torch.core.devicecost.bank_predict`, on the banks' device.
``torch.autograd`` through that surrogate plus
:mod:`repro_torch.optim.adamw` gives :func:`refine`: a few optimizer steps
that walk a knob vector downhill.

The surrogate is a *proposer*, not an oracle: it shares the fitted bank
rows with the fused engine but simplifies the geometry (smooth level
depths, uniform partitioning, no cache-line effects beyond what the
sigmoid rows encode).  :mod:`repro_torch.core.search` therefore only ever
uses gradients to propose knob updates; every decoded discrete design is
scored by the real fused engine (kernel K0) and winners are re-verified
against the scalar oracle (``repro_torch.core.synthesis.cost_workload``).

The objective is conditioned on the workload's read fraction (an
``update`` in the mix pays the get path plus a serial write), so a
read-fraction axis relaxes into the same knob space — the
"read-fraction-conditioned split" of a hybrid design is a per-point
argmin over the relaxed continuum.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import devicecost, elements as el
from repro_torch.core.elements import DataStructureSpec
from repro_torch.core.hardware import HardwareProfile
from repro_torch.optim.adamw import adamw_init, adamw_update, apply_updates

# ---------------------------------------------------------------------------
# Templates: the discrete skeleton the knobs hang off.
# ---------------------------------------------------------------------------
#: internal element classes with a tunable ("fixed", n) fanout knob
INTERNAL_NAMES = ("Hash", "Range", "B+", "CSB+", "Trie")
#: terminal element classes with a tunable ("terminal", c) capacity knob
TERMINAL_NAMES = ("UDP", "ODP")

#: log2 knob bounds: fanouts/partition counts in [2, 65536]
FANOUT_LO, FANOUT_HI = 1.0, 16.0
#: terminal capacities in [16, 65536] (the hill-climb mutation range)
CAPACITY_LO, CAPACITY_HI = 4.0, 16.0
#: bloom filter bits in [1024, 1048576]
BLOOM_LO, BLOOM_HI = 10.0, 20.0

_INTERNAL_BUILDERS = {
    "Hash": lambda n: el.hash_element(n),
    "Range": lambda n: el.range_element(n),
    "B+": lambda n: el.btree_internal(n),
    "CSB+": lambda n: el.csb_internal(n),
    "Trie": lambda n: el.trie_element(n, 4),
}
_TERMINAL_BUILDERS = {
    "UDP": lambda c: el.unordered_data_page(c),
    "ODP": lambda c: el.ordered_data_page(c),
}


@dataclasses.dataclass(frozen=True)
class RelaxTemplate:
    """The structural skeleton of a relaxed design.

    ``levels`` holds the internal element-class names root-first with the
    terminal class last; ``bloom`` adds a per-sub-block bloom filter (and
    its bits knob) to the root level, valid only when the root is a Hash.
    The knob vector of a template has one log2 entry per level plus one
    trailing bloom-bits entry when ``bloom`` is set.
    """

    levels: Tuple[str, ...]
    bloom: bool = False

    def __post_init__(self) -> None:
        if len(self.levels) < 1:
            raise ValueError("template needs at least a terminal level")
        if self.levels[-1] not in TERMINAL_NAMES:
            raise ValueError(f"unknown terminal class: {self.levels[-1]!r}")
        for name in self.levels[:-1]:
            if name not in INTERNAL_NAMES:
                raise ValueError(f"unknown internal class: {name!r}")
        if self.bloom and (len(self.levels) < 2
                           or self.levels[0] != "Hash"):
            raise ValueError("bloom knob requires a Hash root level")

    @property
    def n_knobs(self) -> int:
        return len(self.levels) + (1 if self.bloom else 0)

    def knob_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-knob (lo, hi) log2 bounds, aligned with ``theta``."""
        lo = [FANOUT_LO] * (len(self.levels) - 1) + [CAPACITY_LO]
        hi = [FANOUT_HI] * (len(self.levels) - 1) + [CAPACITY_HI]
        if self.bloom:
            lo.append(BLOOM_LO)
            hi.append(BLOOM_HI)
        return np.asarray(lo), np.asarray(hi)

    def describe(self) -> str:
        tag = "+BF" if self.bloom else ""
        return " -> ".join(self.levels) + tag


@dataclasses.dataclass(frozen=True)
class RelaxedDesign:
    """One point of the relaxed continuum: a template plus log2 knobs."""

    template: RelaxTemplate
    theta: Tuple[float, ...]

    def __post_init__(self) -> None:
        if len(self.theta) != self.template.n_knobs:
            raise ValueError(
                f"{len(self.theta)} knobs for a "
                f"{self.template.n_knobs}-knob template "
                f"{self.template.describe()!r}")

    def clipped(self) -> "RelaxedDesign":
        lo, hi = self.template.knob_bounds()
        return RelaxedDesign(
            self.template,
            tuple(float(v) for v in np.clip(self.theta, lo, hi)))


def decode(design: RelaxedDesign, name: str = "relaxed"
           ) -> DataStructureSpec:
    """Round a relaxed design back to a discrete, valid specification.

    Knobs round to the nearest integer in linear space (clipped to the
    template's bounds first), so two designs within half an integer knob
    step decode identically — the discretization the search's seen-set
    dedups on.
    """
    design = design.clipped()
    template = design.template
    theta = design.theta
    chain = []
    for i, level in enumerate(template.levels[:-1]):
        fanout = max(int(round(2.0 ** theta[i])), 2)
        element = _INTERNAL_BUILDERS[level](fanout)
        if i == 0 and template.bloom:
            bits = max(int(round(2.0 ** theta[-1])), 8)
            element = element.with_values(
                bloom_filters=("on", 2, bits),
                filters_memory_layout="scatter")
        chain.append(element)
    capacity = max(int(round(2.0 ** theta[len(template.levels) - 1])), 16)
    chain.append(_TERMINAL_BUILDERS[template.levels[-1]](capacity))
    return DataStructureSpec(name, tuple(chain))


def encode(spec: DataStructureSpec) -> Optional[RelaxedDesign]:
    """The inverse of :func:`decode` where one exists.

    Returns ``None`` for chains outside the relaxable family (unlimited
    fanouts, unknown element classes, non-knob primitive settings), so
    callers can seed a population from discrete search results without
    special-casing."""
    levels = []
    theta = []
    bloom = False
    for i, element in enumerate(spec.chain[:-1]):
        if element.name not in INTERNAL_NAMES:
            return None
        fanout = element.fanout
        if fanout is None:
            return None
        levels.append(element.name)
        theta.append(float(np.log2(fanout)))
        bf = element.get("bloom_filters")
        if isinstance(bf, tuple) and bf[0] == "on":
            if i != 0 or element.name != "Hash":
                return None
            bloom = True
            bloom_theta = float(np.log2(bf[2]))
    terminal = spec.chain[-1]
    if terminal.name not in TERMINAL_NAMES or terminal.capacity is None:
        return None
    levels.append(terminal.name)
    theta.append(float(np.log2(terminal.capacity)))
    if bloom:
        theta.append(bloom_theta)
    try:
        template = RelaxTemplate(tuple(levels), bloom)
    except ValueError:
        return None
    return RelaxedDesign(template, tuple(theta)).clipped()


# ---------------------------------------------------------------------------
# The smooth surrogate: real bank rows, relaxed geometry.
# ---------------------------------------------------------------------------
#: Level-2 model name used per surrogate term
_SORTED_SEARCH = "binary_search_columnstore"
_HASH_PROBE = "hash_probe_multiply_shift"
_BLOOM_PROBE = "bloom_probe_multiply_shift"
_RANDOM_ACCESS = "random_memory_access"
_SCAN = "scalar_scan_columnstore_equal"
_SERIAL_WRITE = "serial_write"

_SURROGATE_MODELS = (_SORTED_SEARCH, _HASH_PROBE, _BLOOM_PROBE,
                     _RANDOM_ACCESS, _SCAN, _SERIAL_WRITE)


def _surrogate_rows() -> Dict[str, int]:
    """Interned bank-row ids of the surrogate's model zoo (process-wide,
    shared with the fused engine's frontier records)."""
    return {name: devicecost.model_id(name) for name in _SURROGATE_MODELS}


def _one(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=512)
def _surrogate_fn(template: RelaxTemplate):
    """The ``(cost, grad_theta)`` function of one template.

    The template's level structure is baked into the closure (a bounded
    set of templates appears in any search run); banks, data size and
    read fraction are tensor inputs on the banks' device, so a hardware
    swap reuses the closure.  The reference jits ``value_and_grad`` of
    the same cost; here ``torch.autograd.grad`` takes the gradient
    through the plain ``bank_predict``.  It returns the value (0-d) and
    the gradient as float32 tensors on the device; nothing is read back
    to the host.
    """
    rows = _surrogate_rows()
    levels = template.levels
    bloom = template.bloom
    id_list = []      # bank rows, one per surrogate term (static)
    for i, level in enumerate(levels[:-1]):
        if level in ("B+", "CSB+", "Range"):
            id_list.append(rows[_SORTED_SEARCH])
        elif level == "Hash":
            if i == 0 and bloom:
                id_list.append(rows[_BLOOM_PROBE])
            id_list += [rows[_HASH_PROBE], rows[_RANDOM_ACCESS]]
        else:
            id_list.append(rows[_RANDOM_ACCESS])
    id_list.append(rows[_SORTED_SEARCH] if levels[-1] == "ODP"
                   else rows[_SCAN])
    id_list.append(rows[_SERIAL_WRITE])
    ids_on: Dict[torch.device, torch.Tensor] = {}

    def cost(theta, banks, n_entries, read_fraction, value_bytes):
        one = _one(theta)
        two = 2.0 * one
        cap = 2.0 ** theta[len(levels) - 1]
        xs = []          # model input sizes, one per surrogate term
        weights = []     # smooth visit counts, aligned with xs
        n = n_entries
        for i, level in enumerate(levels[:-1]):
            fanout = 2.0 ** theta[i]
            log_f = torch.log(torch.maximum(fanout, two))
            if level in ("B+", "CSB+"):
                # recursive sorted level: height to reach leaves of the
                # terminal's capacity, one bounded search per node
                depth = torch.maximum(
                    torch.log(torch.maximum(n / cap, two)) / log_f, one)
                xs.append(fanout)
                weights.append(depth)
                n = cap
            elif level == "Range":
                xs.append(fanout)
                weights.append(one)
                n = n / fanout
            elif level == "Hash":
                if i == 0 and bloom:
                    xs.append(2.0 ** theta[-1] / 8.0)
                    weights.append(one)
                xs.append(fanout)
                weights.append(one)
                xs.append(torch.maximum(n, one))
                weights.append(one)
                n = n / fanout
            else:      # Trie: radix descent, one random access per hop
                depth = torch.minimum(
                    torch.log(torch.maximum(n, two)) / log_f, 4.0 * one)
                xs.append(fanout)
                weights.append(depth)
                n = n / fanout ** depth
            n = torch.maximum(n, one)
        page = torch.minimum(torch.maximum(n, one), cap)
        if levels[-1] == "ODP":
            xs.append(page)
        else:          # UDP: expected half-page scan
            xs.append(0.5 * page)
        weights.append(one)
        # writes pay the read path plus a serial value write
        xs.append(value_bytes)
        weights.append(1.0 - read_fraction)
        ids = ids_on.get(theta.device)
        if ids is None:
            ids = torch.tensor(id_list, dtype=torch.int32,
                               device=theta.device)
            ids_on[theta.device] = ids
        y = devicecost.bank_predict(banks, ids, torch.stack(xs),
                                    with_knn=False)
        return (torch.stack(weights) * y).sum()

    def value_and_grad(theta, banks, n_entries, read_fraction,
                       value_bytes):
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            value = cost(theta, banks, n_entries, read_fraction,
                         value_bytes)
            (grad,) = torch.autograd.grad(value, theta)
        return value.detach(), grad

    return value_and_grad


def _scalars(table: devicecost.DeviceTable, *values: float
             ) -> Tuple[torch.Tensor, ...]:
    """float32 0-d tensors on the table's device."""
    return tuple(torch.tensor(float(v), dtype=torch.float32,
                              device=table.device) for v in values)


def surrogate_cost(design: RelaxedDesign, hw: HardwareProfile,
                   n_entries: float, read_fraction: float = 1.0,
                   value_bytes: float = 8.0) -> float:
    """The smooth surrogate's per-query cost estimate (diagnostics)."""
    table = devicecost.device_table(hw)
    value, _ = _surrogate_fn(design.template)(
        torch.tensor(design.theta, dtype=torch.float32, device=table.device),
        table.banks, *_scalars(table, n_entries, read_fraction,
                               value_bytes))
    return float(value)


@dataclasses.dataclass(frozen=True)
class _RefineConfig:
    """The RunConfig slice :func:`repro_torch.optim.adamw.adamw_update`
    reads — a constant schedule (no warmup, no cosine decay tail)."""

    learning_rate: float
    warmup_steps: int = 0
    total_steps: int = 1 << 30     # flat schedule over any step count
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95


def refine(design: RelaxedDesign, hw: HardwareProfile,
           n_entries: float, read_fraction: float = 1.0,
           value_bytes: float = 8.0, steps: int = 8,
           learning_rate: float = 0.35) -> RelaxedDesign:
    """Walk a knob vector downhill on the surrogate with AdamW.

    Returns the refined (clipped) design; the caller decodes it and
    scores the discrete result with the real fused engine — gradients
    only ever *propose*.  Knobs are projected back into the template's
    log2 bounds after every step, so the optimizer cannot escape the
    decodable continuum.  The steps run on the banks' device; the knobs
    are read back once, at the end.
    """
    grad_fn = _surrogate_fn(design.template)
    table = devicecost.device_table(hw)
    banks, dev = table.banks, table.device
    lo, hi = design.template.knob_bounds()
    params = {"theta": torch.tensor(design.theta, dtype=torch.float32,
                                    device=dev)}
    state = adamw_init(params)
    run = _RefineConfig(learning_rate=learning_rate)
    n, r, vb = _scalars(table, n_entries, read_fraction, value_bytes)
    lo_t = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi_t = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    for _ in range(max(int(steps), 1)):
        _, grad = grad_fn(params["theta"], banks, n, r, vb)
        updates, state = adamw_update({"theta": grad}, state, params, run)
        params = apply_updates(params, updates)
        params = {"theta": torch.minimum(torch.maximum(params["theta"],
                                                       lo_t), hi_t)}
    return RelaxedDesign(design.template,
                         tuple(float(v) for v in np.asarray(
                             params["theta"].cpu().numpy(), np.float64)))


def read_fraction_of(mix: Optional[Dict[str, float]],
                     default_queries: float = 100.0) -> float:
    """The read share of an operation mix (``get``/``range_get`` weight
    over total) — the conditioning input of the relaxed objective."""
    if not mix:
        return 1.0
    total = sum(float(v) for v in mix.values())
    if total <= 0.0:
        return 1.0
    reads = sum(float(v) for op, v in mix.items()
                if op in ("get", "range_get"))
    return reads / total
