"""Population-based design search over the relaxed continuum.

The port's twin of the reference's ``core/search.py``.  The fused engine
prices a *population* the same as a single design: one
:func:`repro_torch.core.batchcost.pack_sweep` / ``score_sweep`` call per
generation scores every not-yet-seen candidate against every sweep
point in one launch of kernel K0.  :func:`population_search` exploits
that with a classic evolutionary loop — tournament selection,
structural crossover at template (level) boundaries, gaussian knob
mutation in log2 space — hybridized with gradient refinement of the
elite through :func:`repro_torch.core.relax.refine` (``torch.autograd``
through the same parameter banks the fused scorer reads).  Every
``random.Random`` call comes in the reference's order, so a seed chooses
the same design in both packages.

Three invariants the loop maintains:

* **Survivors are never re-packed.**  A ``seen`` memo maps decoded
  chains to their scored cost; only genuinely new chains reach
  ``cost_sweep``, and those hit the incremental ``pack_frontier``
  segment memos for any structurally-shared levels.  After warmup the
  generation loop asks for no new K0 specialisation
  (:func:`repro_torch.core.devicecost.specialisation_count`).
* **Budgets are designs-costed.**  A :class:`SearchBudget` counts every
  distinct design that reaches an engine, shared verbatim with
  ``design_hillclimb``/``design_beam`` so "equal budget" comparisons
  are exact, not wall-clock approximations.
* **Winners are oracle-verified.**  Whenever the incumbent best design
  changes, it is re-scored by the scalar expert system
  (:func:`repro_torch.core.synthesis.cost_workload`) and must agree with
  the engine to 1e-6 relative before being reported; the reported design
  is always the *discrete* rounding (:func:`repro_torch.core.relax.decode`),
  the relaxation never leaks out.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import batchcost, relax, synthesis
from repro_torch.core.elements import DataStructureSpec
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.relax import RelaxTemplate, RelaxedDesign
from repro_torch.core.synthesis import Workload

#: relative tolerance of the winner-vs-scalar-oracle check
ORACLE_RTOL = 1e-6

#: default structural skeletons seeding a search population
DEFAULT_TEMPLATES = (
    RelaxTemplate(("B+", "ODP")),
    RelaxTemplate(("CSB+", "ODP")),
    RelaxTemplate(("Hash", "UDP")),
    RelaxTemplate(("Hash", "UDP"), bloom=True),
    RelaxTemplate(("Range", "ODP")),
    RelaxTemplate(("Range", "B+", "ODP")),
    RelaxTemplate(("Hash", "B+", "ODP"), bloom=True),
    RelaxTemplate(("Trie", "UDP")),
)

#: crossover/mutation never grow chains beyond this many internal levels
MAX_INTERNAL_LEVELS = 3

#: the log2 jitter the mutation sigma anneals down to as budget depletes
FINE_SIGMA = 0.08


class BudgetExhausted(RuntimeError):
    """Raised by :meth:`SearchBudget.charge` when nothing remains."""


class SearchBudget:
    """Designs-costed accounting shared by every search strategy.

    ``charge(n)`` grants up to ``n`` units and returns the granted
    count (possibly smaller near the limit, zero raising
    :class:`BudgetExhausted`), so callers can truncate a candidate batch
    to exactly what the budget allows.  Thread-safe: the serving tier
    charges search requests from worker threads.
    """

    def __init__(self, limit: int) -> None:
        if limit < 1:
            raise ValueError("budget limit must be >= 1")
        self.limit = int(limit)
        self._spent = 0
        self._lock = threading.Lock()

    @property
    def spent(self) -> int:
        return self._spent

    @property
    def remaining(self) -> int:
        return max(self.limit - self._spent, 0)

    @property
    def exhausted(self) -> bool:
        return self._spent >= self.limit

    def charge(self, n: int) -> int:
        """Reserve up to ``n`` design evaluations; returns the grant."""
        if n < 0:
            raise ValueError("cannot charge a negative design count")
        with self._lock:
            grant = min(n, self.limit - self._spent)
            if n > 0 and grant == 0:
                raise BudgetExhausted(
                    f"designs-costed budget {self.limit} exhausted")
            self._spent += grant
            return grant

    def __repr__(self) -> str:
        return (f"SearchBudget(spent={self._spent}, "
                f"limit={self.limit})")


# ---------------------------------------------------------------------------
# Evolutionary operators (pure functions of an explicit random.Random).
# ---------------------------------------------------------------------------
def random_design(rng: random.Random, template: RelaxTemplate
                  ) -> RelaxedDesign:
    """Uniform knob sample inside the template's log2 bounds."""
    lo, hi = template.knob_bounds()
    theta = tuple(rng.uniform(float(a), float(b))
                  for a, b in zip(lo, hi))
    return RelaxedDesign(template, theta)


def mutate(rng: random.Random, design: RelaxedDesign,
           sigma: float = 0.6, structural_p: float = 0.25
           ) -> RelaxedDesign:
    """Gaussian log2 knob jitter, occasionally a structural edit.

    Structural edits stay inside the relaxable family: swap one internal
    level's class, add/drop an internal level (depth capped), swap the
    terminal class, or toggle the root bloom filter — each re-using the
    surviving knob values so a structural step doesn't reset tuning.
    """
    template = design.template
    theta = list(design.theta)
    if rng.random() < structural_p:
        levels = list(template.levels)
        internals = levels[:-1]
        bloom = template.bloom
        bloom_theta = theta[-1] if bloom else rng.uniform(
            relax.BLOOM_LO, relax.BLOOM_HI)
        knobs = theta[:len(levels)]          # per-level knobs only
        move = rng.choice(("swap", "grow", "shrink", "terminal", "bloom"))
        if move == "swap" and internals:
            i = rng.randrange(len(internals))
            internals[i] = rng.choice(relax.INTERNAL_NAMES)
        elif move == "grow" and len(internals) < MAX_INTERNAL_LEVELS:
            i = rng.randrange(len(internals) + 1)
            internals.insert(i, rng.choice(relax.INTERNAL_NAMES))
            knobs.insert(i, rng.uniform(relax.FANOUT_LO, relax.FANOUT_HI))
        elif move == "shrink" and len(internals) > 1:
            i = rng.randrange(len(internals))
            del internals[i]
            del knobs[i]
        elif move == "terminal":
            knobs[-1] = rng.uniform(relax.CAPACITY_LO, relax.CAPACITY_HI)
            levels[-1] = ("UDP" if levels[-1] == "ODP" else "ODP")
        else:
            bloom = not bloom
        bloom = bloom and bool(internals) and internals[0] == "Hash"
        template = RelaxTemplate((*internals, levels[-1]), bloom)
        theta = knobs + ([bloom_theta] if bloom else [])
    theta = [v + rng.gauss(0.0, sigma) for v in theta]
    return RelaxedDesign(template, tuple(theta)).clipped()


def crossover(rng: random.Random, a: RelaxedDesign, b: RelaxedDesign
              ) -> RelaxedDesign:
    """Structural crossover at a template (level) boundary.

    Splices a prefix of ``a``'s internal levels onto a suffix of ``b``'s
    chain (terminal included), knobs travelling with their levels, so
    offspring inherit *tuned* sub-structures rather than random knobs.
    The root bloom filter follows whichever parent contributes the root.
    """
    a_internals = len(a.template.levels) - 1
    cut_a = rng.randint(0, a_internals)
    b_internals = len(b.template.levels) - 1
    cut_b = rng.randint(0, b_internals)
    levels = (a.template.levels[:cut_a]
              + b.template.levels[cut_b:-1])[:MAX_INTERNAL_LEVELS]
    knobs = (list(a.theta[:cut_a])
             + list(b.theta[cut_b:b_internals]))[:MAX_INTERNAL_LEVELS]
    levels = levels + (b.template.levels[-1],)
    knobs.append(b.theta[b_internals])       # terminal capacity knob
    if cut_a > 0:
        bloom = a.template.bloom
        bloom_theta = a.theta[-1] if bloom else 0.0
    else:
        bloom = b.template.bloom and cut_b == 0
        bloom_theta = b.theta[-1] if bloom else 0.0
    bloom = bloom and len(levels) > 1 and levels[0] == "Hash"
    if bloom:
        knobs.append(bloom_theta)
    return RelaxedDesign(RelaxTemplate(levels, bloom),
                         tuple(knobs)).clipped()


def _tournament(rng: random.Random, pop: Sequence[RelaxedDesign],
                fits: Sequence[float], k: int) -> RelaxedDesign:
    picks = [rng.randrange(len(pop)) for _ in range(max(k, 1))]
    return pop[min(picks, key=lambda i: fits[i])]


# ---------------------------------------------------------------------------
# The search loop.
# ---------------------------------------------------------------------------
def _verify_winner(spec: DataStructureSpec, engine_cost: float,
                   points, hw: HardwareProfile) -> float:
    """Scalar-oracle check of a reported winner (mean over sweep points).

    Raises ``AssertionError`` on disagreement beyond :data:`ORACLE_RTOL`
    — a search must never report a design the expert system disowns.
    """
    oracle = float(np.mean([
        synthesis.cost_workload(spec, w, hw, dict(mix_items))
        for w, mix_items in points]))
    err = abs(oracle - engine_cost) / max(abs(oracle), 1e-30)
    if err > ORACLE_RTOL:
        raise AssertionError(
            f"winner {spec.name!r} fails oracle verification: "
            f"engine {engine_cost!r} vs scalar {oracle!r} "
            f"(rel err {err:.3e} > {ORACLE_RTOL})")
    return oracle


def population_search(
        workload: Workload, hw: HardwareProfile,
        mix: Optional[Dict[str, float]] = None, *,
        budget: SearchBudget,
        population: int = 24, generations: int = 12,
        tournament: int = 3, mutation_sigma: float = 0.6,
        crossover_rate: float = 0.6, refine_top: int = 4,
        refine_steps: int = 4, seed: int = 0, engine: str = "fused",
        templates: Sequence[RelaxTemplate] = DEFAULT_TEMPLATES,
        seeds: Sequence[DataStructureSpec] = (),
        workloads: Optional[Sequence[Workload]] = None,
        mixes=None,
        score_fn: Optional[Callable[
            [List[DataStructureSpec]], np.ndarray]] = None,
        verify_oracle: bool = True) -> Dict[str, object]:
    """Evolve a population of relaxed designs under a designs budget.

    Each generation decodes the population to discrete chains, scores
    the never-seen ones in **one** ``cost_sweep`` call (every sweep
    point, every new design, one fused evaluation), then breeds the next
    generation by tournament selection, structural crossover, knob
    mutation and AdamW refinement of the elite.  Fitness is the mean
    engine cost over the sweep points (pass ``workloads``/``mixes`` for
    a multi-point axis, e.g. a read-fraction sweep).  ``score_fn``
    overrides the scoring call (the serving tier injects its
    deadline/fault-healing path); it must return one cost per spec.

    Returns the ``design_beam``-shaped result dict (``design``,
    ``fanouts``, ``cost_s``, ``designs_costed``, ``elapsed_s``, ...)
    plus search diagnostics (``refine_s``: the seconds spent in
    :func:`repro_torch.core.relax.refine`), with the winner
    oracle-verified.
    """
    if population < 2:
        raise ValueError("population must be >= 2")
    t0 = time.perf_counter()
    rng = random.Random(seed)
    points = batchcost.normalize_points(
        list(workloads) if workloads is not None else [workload],
        mixes if mixes is not None else mix)
    read_fraction = float(np.mean([
        relax.read_fraction_of(dict(mi)) for _, mi in points]))

    if score_fn is None:
        def score_fn(specs: List[DataStructureSpec]) -> np.ndarray:
            grid = batchcost.cost_sweep(
                specs, [w for w, _ in points], hw,
                [dict(mi) for _, mi in points], engine=engine)
            return np.asarray(grid, np.float64).mean(axis=0)

    seen: Dict[tuple, float] = {}       # chain -> mean engine cost

    def score_population(pop: List[RelaxedDesign]
                         ) -> Tuple[List[float], bool]:
        """One engine call for the generation; True when budget ran dry."""
        decoded = [relax.decode(d, f"gen{generation}_{i}")
                   for i, d in enumerate(pop)]
        fresh: List[DataStructureSpec] = []
        fresh_chains = set()
        for spec in decoded:
            if spec.chain not in seen and spec.chain not in fresh_chains:
                fresh.append(spec)
                fresh_chains.add(spec.chain)
        truncated = False
        if fresh:
            try:
                grant = budget.charge(len(fresh))
            except BudgetExhausted:
                grant = 0
            truncated = grant < len(fresh)
            fresh = fresh[:grant]
        if fresh:
            costs = score_fn(fresh)
            for spec, cost in zip(fresh, costs):
                seen[spec.chain] = float(cost)
        fits = [seen.get(spec.chain, float("inf")) for spec in decoded]
        return fits, truncated

    # -- generation 0: template-stratified random init + encoded seeds --
    pop: List[RelaxedDesign] = []
    for spec in seeds:
        enc = relax.encode(spec)
        if enc is not None:
            pop.append(enc)
    i = 0
    while len(pop) < population:
        pop.append(random_design(rng, templates[i % len(templates)]))
        i += 1
    pop = pop[:max(population, len(pop))]

    best_design: Optional[RelaxedDesign] = None
    best_spec: Optional[DataStructureSpec] = None
    best_cost = float("inf")
    history: List[float] = []
    verified_cost: Optional[float] = None
    generation = 0
    exhausted = False
    refine_s = 0.0
    for generation in range(generations):
        fits, exhausted = score_population(pop)
        ranked = sorted(range(len(pop)), key=lambda i: fits[i])
        if fits[ranked[0]] < best_cost * (1.0 - 1e-12):
            best_cost = fits[ranked[0]]
            best_design = pop[ranked[0]]
            best_spec = relax.decode(best_design, "winner")
            if verify_oracle:
                verified_cost = _verify_winner(
                    best_spec, best_cost, points, hw)
        history.append(best_cost)
        if exhausted or budget.exhausted or generation == generations - 1:
            break
        # -- breed the next generation ------------------------------------
        elite = []
        for i in ranked:
            if np.isfinite(fits[i]) and pop[i] not in elite:
                elite.append(pop[i])
            if len(elite) >= max(refine_top, 1):
                break
        # anneal the knob jitter on budget *spent*, not generation count:
        # coarse structural exploration while designs are cheap, fine
        # continuum exploitation (below any pow2 grid step) near the end
        frac = budget.spent / budget.limit
        sigma = mutation_sigma * (
            min(FINE_SIGMA, mutation_sigma) / mutation_sigma) ** frac
        children: List[RelaxedDesign] = list(elite[:2])   # elitism
        t_refine = time.perf_counter()
        for d in elite[:refine_top]:
            if refine_steps > 0:
                children.append(relax.refine(
                    d, hw, float(points[0][0].n_entries),
                    read_fraction, steps=refine_steps))
        refine_s += time.perf_counter() - t_refine
        for d in elite:                     # pure-knob local exploitation
            children.append(mutate(rng, d, FINE_SIGMA, structural_p=0.0))
        # one random immigrant keeps structural diversity from draining
        children.append(random_design(
            rng, templates[rng.randrange(len(templates))]))
        while len(children) < population:
            parent = _tournament(rng, pop, fits, tournament)
            if rng.random() < crossover_rate:
                other = _tournament(rng, pop, fits, tournament)
                child = crossover(rng, parent, other)
            else:
                child = parent
            children.append(mutate(rng, child, sigma))
        pop = children[:population]

    if best_spec is None:
        raise BudgetExhausted(
            "budget exhausted before any design was scored")
    fanouts = tuple(e.fanout or e.capacity for e in best_spec.chain)
    return {
        "design": best_spec,
        "template": best_design.template.describe(),
        "theta": best_design.theta,
        "fanouts": fanouts,
        "cost_s": best_cost,
        "oracle_cost_s": verified_cost,
        "designs_costed": budget.spent,
        "generations": generation + 1,
        "history": history,
        "elapsed_s": time.perf_counter() - t0,
        "refine_s": refine_s,
        "budget_exhausted": exhausted or budget.exhausted,
        "engine": engine,
    }
