"""The port's relaxed continuum and design search (``core/relax.py``,
``core/search.py``, the search half of ``core/autocomplete.py``,
``optim/adamw.py``), on the CPU.

Mirrors ``tests/test_search.py`` (all but its two serving-tier tests,
which wait for the port of ``serving/``) and the search case of
``tests/test_whatif_autocomplete.py``, and adds parity with the
reference on the same seeds and budgets: decoded and encoded designs
identical, the surrogate's cost within 1e-6 relative, its gradient
within ``GRAD_RTOL`` (below), ``refine``'s decoded design identical, and
``population_search``, ``design_beam``, ``design_hillclimb`` and
``design_hybrid`` choosing identical winners with identical
``designs_costed`` and generations, their costs within 1e-6.

``GRAD_RTOL``: the gradient runs back through float32 ``log``/``exp``
(and a sigmoid's ``s (1 - s)``) that XLA and torch round an ulp apart on
some inputs, and through sums whose terms cancel, so a component can
lose digits against the largest; each component is held within 1e-4 of
the gradient's largest component (the worst seen when this test was
written: 2.4e-5 of it).  AdamW normalizes the gradient (``m /
sqrt(v)``), so such a difference moves a refined knob by far less than
the half step that would change its decoded design.
"""
import inspect
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autocomplete as r_ac, devicecost as r_dc
from repro.core import elements as r_el, hardware as r_hw
from repro.core import relax as r_relax, search as r_search
from repro.core import synthesis as r_syn
from repro.optim import adamw as r_adamw
from repro_torch import runtime
from repro_torch.configs.base import RunConfig
from repro_torch.core import autocomplete as p_ac, batchcost
from repro_torch.core import devicecost as p_dc
from repro_torch.core import elements as el, hardware as p_hw
from repro_torch.core import relax, search
from repro_torch.core.hardware import hw1
from repro_torch.core.relax import RelaxedDesign, RelaxTemplate
from repro_torch.core.synthesis import Workload, cost_workload
from repro_torch.optim import adamw

WORKLOAD = Workload(n_entries=1 << 16, n_queries=100)
R_WORKLOAD = r_syn.Workload(n_entries=1 << 16, n_queries=100)
MIX = {"get": 80.0, "update": 20.0}
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _ref_design(design):
    return r_relax.RelaxedDesign(
        r_relax.RelaxTemplate(design.template.levels, design.template.bloom),
        design.theta)


# ---------------------------------------------------------------------------
# SearchBudget
# ---------------------------------------------------------------------------
def test_budget_charges_and_truncates():
    b = search.SearchBudget(10)
    assert b.charge(4) == 4
    assert b.spent == 4 and b.remaining == 6 and not b.exhausted
    assert b.charge(8) == 6          # truncated to the remaining grant
    assert b.exhausted
    with pytest.raises(search.BudgetExhausted):
        b.charge(1)
    assert b.charge(0) == 0          # zero-charge probe never raises


def test_budget_rejects_bad_arguments():
    with pytest.raises(ValueError):
        search.SearchBudget(0)
    with pytest.raises(ValueError):
        search.SearchBudget(5).charge(-1)


def test_budget_thread_safe_exact_total():
    b = search.SearchBudget(1000)
    granted = []

    def worker():
        local = 0
        while True:
            try:
                local += b.charge(7)
            except search.BudgetExhausted:
                break
        granted.append(local)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(granted) == 1000 == b.spent


# ---------------------------------------------------------------------------
# relax: encode/decode bridge
# ---------------------------------------------------------------------------
def test_decode_encode_roundtrip_exact():
    rng = random.Random(7)
    for template in search.DEFAULT_TEMPLATES:
        for _ in range(16):
            design = search.random_design(rng, template)
            spec = relax.decode(design)
            back = relax.encode(spec)
            assert back is not None
            assert relax.decode(back).chain == spec.chain


def test_encode_rejects_foreign_chains():
    assert relax.encode(el.spec_skip_list()) is None


def test_template_validation():
    with pytest.raises(ValueError):
        RelaxTemplate(("UDP", "B+"))          # terminal must come last
    with pytest.raises(ValueError):
        RelaxTemplate(("B+", "ODP"), bloom=True)   # bloom needs Hash root


def test_decode_respects_knob_floors():
    d = RelaxedDesign(RelaxTemplate(("B+", "ODP")), (-3.0, -3.0)).clipped()
    spec = relax.decode(d)
    assert spec.chain[0].fanout >= 2 and spec.chain[-1].capacity >= 16


def test_decode_encode_match_reference():
    """Same knobs -> the same discrete chain; the same chain -> the same
    knobs (random designs of every template, and the paper's specs)."""
    rng = random.Random(13)
    for template in search.DEFAULT_TEMPLATES:
        for _ in range(24):
            design = search.random_design(rng, template)
            got = relax.decode(design, "x")
            want = r_relax.decode(_ref_design(design), "x")
            assert got.describe() == want.describe()
            assert [e.get("fanout") for e in got.chain] == \
                [e.get("fanout") for e in want.chain]
            back, r_back = relax.encode(got), r_relax.encode(want)
            assert back.theta == r_back.theta
            assert back.template.levels == r_back.template.levels
            assert back.template.bloom == r_back.template.bloom
    for name in sorted(el.ALL_PAPER_SPECS):
        make, r_make = el.ALL_PAPER_SPECS[name], r_el.ALL_PAPER_SPECS[name]
        args = (1000,) if "n_puts" in inspect.signature(make).parameters \
            else ()
        got, want = relax.encode(make(*args)), r_relax.encode(r_make(*args))
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.theta == want.theta, name


# ---------------------------------------------------------------------------
# The surrogate and refine against the reference
# ---------------------------------------------------------------------------
def _designs(seed, per_template):
    rng = random.Random(seed)
    return [search.random_design(rng, t) for t in search.DEFAULT_TEMPLATES
            for _ in range(per_template)]


def _port_grad(design, hw, n, rf):
    """The port surrogate's gradient in theta, as the reference's is read
    below: through the template's closure."""
    banks = p_dc.device_table(hw).banks
    scalars = [torch.tensor(v, dtype=torch.float32) for v in (n, rf, 8.0)]
    _, grad = relax._surrogate_fn(design.template)(
        torch.tensor(design.theta, dtype=torch.float32), banks, *scalars)
    return grad.numpy()


@pytest.mark.parametrize("make", ["hw1", "hw3"])
def test_surrogate_cost_and_grad_match_reference(make):
    p_prof, r_prof = getattr(p_hw, make)(), getattr(r_hw, make)()
    banks = r_dc.device_table(r_prof).banks
    for design in _designs(7, 6):
        for n, rf in ((1e6, 0.8), (1 << 16, 1.0), (3e8, 0.25)):
            got = relax.surrogate_cost(design, p_prof, n, rf)
            want = r_relax.surrogate_cost(_ref_design(design), r_prof, n, rf)
            assert abs(got - want) <= 1e-6 * abs(want), (design, got, want)
            g = _port_grad(design, p_prof, n, rf)
            _, gr = r_relax._surrogate_fn(_ref_design(design).template)(
                jnp.asarray(design.theta, jnp.float32), banks,
                jnp.float32(n), jnp.float32(rf), jnp.float32(8.0))
            gr = np.asarray(gr)
            assert np.isfinite(g).all()
            np.testing.assert_allclose(
                g, gr, rtol=0, atol=GRAD_RTOL * float(np.abs(gr).max()))


@pytest.mark.parametrize("make", ["hw1", "hw3"])
def test_refine_decodes_like_reference(make):
    p_prof, r_prof = getattr(p_hw, make)(), getattr(r_hw, make)()
    for design in _designs(21, 3):
        for steps in (1, 4):
            got = relax.refine(design, p_prof, 1e6, 0.8, steps=steps)
            want = r_relax.refine(_ref_design(design), r_prof, 1e6, 0.8,
                                  steps=steps)
            assert relax.decode(got).describe() == \
                r_relax.decode(want).describe()
            lo, hi = design.template.knob_bounds()
            assert all(a <= v <= b for a, v, b in zip(lo, got.theta, hi))
            np.testing.assert_allclose(got.theta, want.theta, rtol=0,
                                       atol=1e-4)


def test_adamw_matches_reference():
    """AdamW with a warmup-cosine schedule and global-norm clipping on a
    small dict of parameters: the same updates as the reference's, step
    for step (float32 throughout)."""
    run = RunConfig(learning_rate=1e-2, warmup_steps=3, total_steps=20,
                    weight_decay=0.1)
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    p = {"a": torch.as_tensor(init["a"]),
         "b": {"c": torch.as_tensor(init["b"]["c"])}}
    r = {"a": jnp.asarray(init["a"]), "b": {"c": jnp.asarray(init["b"]["c"])}}
    p_state, r_state = adamw.adamw_init(p), r_adamw.adamw_init(r)
    for step in range(8):
        g = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal(5).astype(np.float32)}}
        pg, p_norm = adamw.clip_by_global_norm(
            {"a": torch.as_tensor(g["a"]),
             "b": {"c": torch.as_tensor(g["b"]["c"])}}, 1.0)
        rg, r_norm = r_adamw.clip_by_global_norm(
            {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}},
            1.0)
        np.testing.assert_allclose(float(p_norm), float(r_norm), rtol=1e-6)
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(torch.tensor(step), run)),
            float(r_adamw.cosine_schedule(jnp.asarray(step), run)),
            rtol=1e-6)
        pu, p_state = adamw.adamw_update(pg, p_state, p, run)
        ru, r_state = r_adamw.adamw_update(rg, r_state, r, run)
        p = adamw.apply_updates(p, pu)
        r = r_adamw.apply_updates(r, ru)
        assert int(p_state.step) == int(r_state.step) == step + 1
        np.testing.assert_allclose(p["a"].numpy(), np.asarray(r["a"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p["b"]["c"].numpy(),
                                   np.asarray(r["b"]["c"]),
                                   rtol=1e-5, atol=1e-6)
    assert p_state.mu["a"].dtype == torch.float32
    low = adamw.adamw_init(p, moment_dtype=torch.bfloat16)
    assert low.nu["b"]["c"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Evolutionary operators stay inside the decodable family.
# ---------------------------------------------------------------------------
def test_mutate_and_crossover_always_decodable():
    rng = random.Random(11)
    pool = [search.random_design(rng, t) for t in search.DEFAULT_TEMPLATES]
    for _ in range(300):
        a, b = rng.choice(pool), rng.choice(pool)
        child = search.mutate(rng, search.crossover(rng, a, b),
                              sigma=0.8, structural_p=0.5)
        spec = relax.decode(child)        # raises if structurally invalid
        assert len(child.template.levels) - 1 <= search.MAX_INTERNAL_LEVELS
        assert cost_workload(spec, WORKLOAD, hw1(), MIX) > 0.0
        pool.append(child)


def test_operators_draw_like_reference():
    """The same random.Random seed drives the same operator sequence to
    the same designs in both packages (the search's determinism contract
    rests on the call order)."""
    p_rng, r_rng = random.Random(99), random.Random(99)
    p_pool = [search.random_design(p_rng, t)
              for t in search.DEFAULT_TEMPLATES]
    r_pool = [r_search.random_design(r_rng, t)
              for t in r_search.DEFAULT_TEMPLATES]
    for _ in range(200):
        i, j = p_rng.randrange(len(p_pool)), p_rng.randrange(len(p_pool))
        assert (i, j) == (r_rng.randrange(len(r_pool)),
                          r_rng.randrange(len(r_pool)))
        pc = search.mutate(p_rng, search.crossover(p_rng, p_pool[i],
                                                   p_pool[j]), 0.7, 0.4)
        rc = r_search.mutate(r_rng, r_search.crossover(r_rng, r_pool[i],
                                                       r_pool[j]), 0.7, 0.4)
        assert pc.theta == rc.theta
        assert pc.template.levels == rc.template.levels
        assert pc.template.bloom == rc.template.bloom
        p_pool.append(pc)
        r_pool.append(rc)


# ---------------------------------------------------------------------------
# population_search contracts
# ---------------------------------------------------------------------------
def test_population_search_verifies_and_stays_in_budget():
    hw = hw1()
    result = search.population_search(
        WORKLOAD, hw, MIX, budget=search.SearchBudget(64),
        population=8, generations=50, refine_top=2, refine_steps=2,
        seed=3)
    assert result["designs_costed"] <= 64
    oracle = cost_workload(result["design"], WORKLOAD, hw, MIX)
    assert abs(oracle - result["cost_s"]) / oracle <= search.ORACLE_RTOL
    assert result["oracle_cost_s"] is not None
    # best-so-far history is monotone non-increasing
    assert all(a >= b for a, b in zip(result["history"],
                                      result["history"][1:]))


def test_population_search_deterministic():
    hw = hw1()
    runs = [search.population_search(
        WORKLOAD, hw, MIX, budget=search.SearchBudget(48),
        population=8, generations=50, seed=5) for _ in range(2)]
    assert runs[0]["cost_s"] == runs[1]["cost_s"]
    assert runs[0]["design"].chain == runs[1]["design"].chain


def test_population_search_charges_only_fresh_chains():
    """The seen-set dedups across generations: total designs charged
    equals the number of distinct chains that reached the engine."""
    hw = hw1()
    scored = []

    def spy(specs):
        scored.extend(s.chain for s in specs)
        grid = batchcost.cost_sweep(specs, [WORKLOAD], hw, MIX)
        return np.asarray(grid, np.float64).mean(axis=0)

    result = search.population_search(
        WORKLOAD, hw, MIX, budget=search.SearchBudget(64),
        population=8, generations=50, seed=3, score_fn=spy)
    assert len(scored) == len(set(scored)) == result["designs_costed"]


def test_population_search_tiny_budget_raises():
    # the budget dies mid-generation-0 scoring with nothing reported
    with pytest.raises(search.BudgetExhausted):
        search.population_search(
            WORKLOAD, hw1(), MIX, budget=search.SearchBudget(1),
            population=8, generations=2, seed=0,
            score_fn=lambda specs: (_ for _ in ()).throw(
                search.BudgetExhausted("no engine call allowed")))


def test_population_search_multi_point_axis():
    hw = hw1()
    wls = [Workload(n_entries=1 << 14, n_queries=100),
           Workload(n_entries=1 << 16, n_queries=100)]
    result = search.population_search(
        WORKLOAD, hw, MIX, budget=search.SearchBudget(48),
        population=8, generations=20, seed=2, workloads=wls)
    mean_oracle = float(np.mean([
        cost_workload(result["design"], w, hw, MIX) for w in wls]))
    assert abs(mean_oracle - result["cost_s"]) / mean_oracle \
        <= search.ORACLE_RTOL


def test_population_search_needs_a_device_choice(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(runtime, "_CHOSEN", None)
    with pytest.raises(runtime.NoDeviceError):
        search.population_search(
            WORKLOAD, hw1(), MIX, budget=search.SearchBudget(8),
            population=4, generations=2, seed=0)
    with pytest.raises(runtime.NoDeviceError):
        relax.refine(search.random_design(random.Random(0),
                                          search.DEFAULT_TEMPLATES[0]),
                     hw1(), 1e6)


# ---------------------------------------------------------------------------
# Budgeted hillclimb/beam
# ---------------------------------------------------------------------------
def test_beam_unconstrained_budget_matches_unbudgeted():
    hw = hw1()
    free = p_ac.design_beam(WORKLOAD, hw, MIX, beam_width=2, max_rounds=4)
    budget = search.SearchBudget(10_000)
    capped = p_ac.design_beam(WORKLOAD, hw, MIX, beam_width=2,
                              max_rounds=4, budget=budget)
    assert capped["cost_s"] == free["cost_s"]
    assert capped["design"] == free["design"]
    assert budget.spent == capped["designs_costed"] \
        == free["designs_costed"]


def test_hillclimb_budget_truncates_and_accounts():
    hw = hw1()
    budget = search.SearchBudget(9)
    result = p_ac.design_hillclimb(WORKLOAD, hw, MIX, max_steps=6,
                                   budget=budget)
    assert budget.spent <= 9
    assert result["designs_costed"] == budget.spent
    assert np.isfinite(result["cost_s"]) and result["cost_s"] > 0.0


def test_hillclimb_unconstrained_budget_matches_unbudgeted():
    hw = hw1()
    free = p_ac.design_hillclimb(WORKLOAD, hw, MIX, max_steps=4)
    budget = search.SearchBudget(10_000)
    capped = p_ac.design_hillclimb(WORKLOAD, hw, MIX, max_steps=4,
                                   budget=budget)
    assert capped["cost_s"] == free["cost_s"]
    assert capped["design"] == free["design"]
    assert budget.spent == capped["designs_costed"]


def test_design_hybrid_two_scenarios():
    """Fig. 9: mixed point/range/write regions produce per-region designs."""
    regions = [
        p_ac.DomainRegion("reads", 0.2, {"get": 100.0}),
        p_ac.DomainRegion("writes", 0.8, {"bulk_load": 1.0, "update": 100.0}),
    ]
    design = p_ac.design_hybrid(Workload(n_entries=1_000_000), regions,
                                hw1())
    assert len(design.regions) == 2
    assert design.cost_seconds > 0
    text = design.describe()
    assert "reads" in text and "writes" in text


# ---------------------------------------------------------------------------
# The searches against the reference: same seed, same budget
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", ["hw1", "hw3"])
@pytest.mark.parametrize("seed", [3, 10])
def test_population_search_matches_reference(make, seed):
    kw = dict(population=8, generations=50, refine_top=2, refine_steps=2,
              seed=seed)
    got = search.population_search(
        WORKLOAD, getattr(p_hw, make)(), MIX,
        budget=search.SearchBudget(64), seeds=[el.spec_btree()], **kw)
    want = r_search.population_search(
        R_WORKLOAD, getattr(r_hw, make)(), MIX,
        budget=r_search.SearchBudget(64), seeds=[r_el.spec_btree()], **kw)
    assert got["design"].describe() == want["design"].describe()
    assert got["template"] == want["template"]
    assert got["fanouts"] == want["fanouts"]
    assert got["designs_costed"] == want["designs_costed"]
    assert got["generations"] == want["generations"]
    assert abs(got["cost_s"] - want["cost_s"]) <= 1e-6 * want["cost_s"]
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-6)


def test_population_search_multi_point_matches_reference():
    fractions = np.linspace(0.0, 1.0, 5)
    mixes = [{"get": 100.0 * f, "update": 100.0 * (1 - f)} for f in fractions]
    got = search.population_search(
        WORKLOAD, p_hw.hw3(), budget=search.SearchBudget(40),
        population=8, generations=20, seed=4,
        workloads=[WORKLOAD] * 5, mixes=mixes)
    want = r_search.population_search(
        R_WORKLOAD, r_hw.hw3(), budget=r_search.SearchBudget(40),
        population=8, generations=20, seed=4,
        workloads=[R_WORKLOAD] * 5, mixes=mixes)
    assert got["design"].describe() == want["design"].describe()
    assert got["designs_costed"] == want["designs_costed"]
    assert got["generations"] == want["generations"]
    assert abs(got["cost_s"] - want["cost_s"]) <= 1e-6 * want["cost_s"]


@pytest.mark.parametrize("make", ["hw1", "hw3"])
def test_beam_and_hillclimb_match_reference(make):
    p_prof, r_prof = getattr(p_hw, make)(), getattr(r_hw, make)()
    got = p_ac.design_beam(WORKLOAD, p_prof, MIX,
                           start=[el.spec_btree(), el.spec_trie()],
                           beam_width=4, max_rounds=8,
                           budget=search.SearchBudget(160))
    want = r_ac.design_beam(R_WORKLOAD, r_prof, MIX,
                            start=[r_el.spec_btree(), r_el.spec_trie()],
                            beam_width=4, max_rounds=8,
                            budget=r_search.SearchBudget(160))
    for key in ("design", "fanouts", "designs_costed", "rounds"):
        assert got[key] == want[key], key
    assert abs(got["cost_s"] - want["cost_s"]) <= 1e-6 * want["cost_s"]
    got = p_ac.design_hillclimb(WORKLOAD, p_prof, MIX, max_steps=8)
    want = r_ac.design_hillclimb(R_WORKLOAD, r_prof, MIX, max_steps=8)
    for key in ("design", "fanouts", "designs_costed"):
        assert got[key] == want[key], key
    assert abs(got["cost_s"] - want["cost_s"]) <= 1e-6 * want["cost_s"]


@pytest.mark.parametrize("make", ["hw1", "hw3"])
def test_design_hybrid_matches_reference(make):
    regions = [("reads", 0.2, {"get": 100.0}),
               ("writes", 0.8, {"bulk_load": 1.0, "update": 100.0})]
    got = p_ac.design_hybrid(
        Workload(n_entries=1_000_000),
        [p_ac.DomainRegion(*r) for r in regions], getattr(p_hw, make)())
    want = r_ac.design_hybrid(
        r_syn.Workload(n_entries=1_000_000),
        [r_ac.DomainRegion(*r) for r in regions], getattr(r_hw, make)())
    assert got.describe() == want.describe()
    assert abs(got.cost_seconds - want.cost_seconds) \
        <= 1e-6 * want.cost_seconds
    for (_, a), (_, b) in zip(got.regions, want.regions):
        assert a.explored == b.explored
        assert abs(a.cost_seconds - b.cost_seconds) <= 1e-6 * b.cost_seconds
