"""Port vs reference: the slice as a whole on the CPU — what-if
questions, a design-continuum sweep and auto-completion over a depth-2
frontier.  Totals agree to rtol 1e-6; chosen designs (argmins) are
identical.
"""
import numpy as np
import pytest

from repro.core import autocomplete as r_ac, elements as r_el
from repro.core import hardware as r_hw, synthesis as r_syn
from repro.core import whatif as r_wi
from repro_torch import runtime
from repro_torch.core import autocomplete as p_ac, elements as p_el
from repro_torch.core import hardware as p_hw, synthesis as p_syn
from repro_torch.core import whatif as p_wi

MIX = {"get": 60.0, "update": 40.0}


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _same_answer(got, want):
    np.testing.assert_allclose(got.baseline_seconds, want.baseline_seconds,
                               rtol=1e-6)
    np.testing.assert_allclose(got.variant_seconds, want.variant_seconds,
                               rtol=1e-6)
    assert got.beneficial == want.beneficial
    assert got.question == want.question


@pytest.mark.parametrize("engine", ["fused", "grouped", "scalar"])
def test_what_if_questions_match_reference(engine):
    w_r, w_p = r_syn.Workload(n_entries=2_000_000), \
        p_syn.Workload(n_entries=2_000_000)
    _same_answer(
        p_wi.what_if_design(p_el.spec_btree(),
                            p_wi.add_bloom_filters(p_el.spec_btree()), w_p,
                            p_hw.hw1(), MIX, engine=engine),
        r_wi.what_if_design(r_el.spec_btree(),
                            r_wi.add_bloom_filters(r_el.spec_btree()), w_r,
                            r_hw.hw1(), MIX, engine=engine))
    _same_answer(
        p_wi.what_if_hardware(p_el.spec_skip_list(), w_p, p_hw.hw2(),
                              p_hw.hw3(), MIX, engine=engine),
        r_wi.what_if_hardware(r_el.spec_skip_list(), w_r, r_hw.hw2(),
                              r_hw.hw3(), MIX, engine=engine))
    _same_answer(
        p_wi.what_if_workload(p_el.spec_hash_table(), w_p,
                              p_syn.Workload(n_entries=2_000_000,
                                             zipf_alpha=1.2),
                              p_hw.hw1(), MIX, engine=engine),
        r_wi.what_if_workload(r_el.spec_hash_table(), w_r,
                              r_syn.Workload(n_entries=2_000_000,
                                             zipf_alpha=1.2),
                              r_hw.hw1(), MIX, engine=engine))


@pytest.mark.parametrize("engine", ["fused", "grouped"])
def test_workload_sweep_matches_reference(engine):
    fractions = np.linspace(0.0, 1.0, 9)
    p_front = p_ac.enumerate_frontier((), max_depth=2)
    r_front = r_ac.enumerate_frontier((), max_depth=2)
    got = p_wi.workload_sweep(p_front,
                              [p_syn.Workload(n_entries=1_000_000)] * 9,
                              p_hw.hw3(), p_wi.read_fraction_mixes(fractions),
                              engine=engine)
    want = r_wi.workload_sweep(r_front,
                               [r_syn.Workload(n_entries=1_000_000)] * 9,
                               r_hw.hw3(),
                               r_wi.read_fraction_mixes(fractions),
                               engine=engine)
    np.testing.assert_allclose(got.totals, want.totals, rtol=1e-6)
    np.testing.assert_array_equal(got.best_indices, want.best_indices)
    assert got.summary().splitlines()[1:] == want.summary().splitlines()[1:]


def test_fused_sweep_holds_scalar_oracle_and_grouped_argmins():
    """Inside the port: fused within 1e-6 of the scalar oracle, argmins
    equal to the grouped engine's."""
    fractions = np.linspace(0.0, 1.0, 5)
    front = p_ac.enumerate_frontier((), max_depth=2)
    workloads = [p_syn.Workload(n_entries=300_000, zipf_alpha=0.7)] * 5
    mixes = p_wi.read_fraction_mixes(fractions)
    fused = p_wi.workload_sweep(front, workloads, p_hw.hw1(), mixes)
    grouped = p_wi.workload_sweep(front, workloads, p_hw.hw1(), mixes,
                                  engine="grouped")
    scalar = p_wi.workload_sweep(front[::7], workloads, p_hw.hw1(), mixes,
                                 engine="scalar")
    np.testing.assert_allclose(fused.totals[:, ::7], scalar.totals,
                               rtol=1e-6)
    np.testing.assert_allclose(grouped.totals[:, ::7], scalar.totals,
                               rtol=1e-9)
    np.testing.assert_array_equal(fused.best_indices, grouped.best_indices)


@pytest.mark.parametrize("partial", [(), ("btree",)])
def test_complete_design_matches_reference(partial):
    def prefix(el):
        return tuple(el.btree_internal(20) for _ in partial)
    w_p = p_syn.Workload(n_entries=5_000_000)
    w_r = r_syn.Workload(n_entries=5_000_000)
    got = p_ac.complete_design(prefix(p_el), w_p, p_hw.hw1(), mix=MIX,
                               max_depth=2)
    want = r_ac.complete_design(prefix(r_el), w_r, r_hw.hw1(), mix=MIX,
                                max_depth=2)
    assert got.spec.describe() == want.spec.describe()
    assert got.explored == want.explored
    np.testing.assert_allclose(got.cost_seconds, want.cost_seconds,
                               rtol=1e-6)
    scalar = p_ac.complete_design(prefix(p_el), w_p, p_hw.hw1(), mix=MIX,
                                  max_depth=2, batched=False)
    assert scalar.spec.describe() == got.spec.describe()


def test_complete_design_sweep_matches_reference():
    fractions = [0.0, 0.3, 0.9, 1.0]
    got = p_ac.design_continuum(
        (), [p_syn.Workload(n_entries=1_000_000)] * 4, p_hw.hw2(),
        mixes=p_wi.read_fraction_mixes(fractions), max_depth=2)
    want = r_ac.design_continuum(
        (), [r_syn.Workload(n_entries=1_000_000)] * 4, r_hw.hw2(),
        mixes=r_wi.read_fraction_mixes(fractions), max_depth=2)
    assert [r.spec.describe() for r in got] == \
        [r.spec.describe() for r in want]
    np.testing.assert_allclose([r.cost_seconds for r in got],
                               [r.cost_seconds for r in want], rtol=1e-6)
