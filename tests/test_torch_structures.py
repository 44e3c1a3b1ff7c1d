"""The port's ground-truth structures (``core/structures.py``) and design
space accounting (``core/design_space.py``), on the CPU.

Mirrors ``tests/test_structures.py`` (behaviour against a dict oracle,
incl. the property sweep) and adds parity with the reference: on the same
seeded data every structure answers exactly as the reference's does, and
the paper's Eq. 1-4 cardinalities are the reference's to the last bit.
"""
import math

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # clean container: deterministic fallback sweeps
    from repro.testing.hypothesis_fallback import (
        given, settings, strategies as st)

from repro.core import design_space as r_ds
from repro.core import structures as r_S
from repro_torch.core import design_space as p_ds
from repro_torch.core import structures as S


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


def _data(rng, n=2000):
    keys = rng.choice(np.arange(n * 4), size=n, replace=False).astype(np.int64)
    values = rng.integers(0, 1 << 30, size=n).astype(np.int64)
    return keys, values


def _build(cls, keys, values):
    s = cls()
    s.bulk_load(keys, values)
    return s


def test_same_structures_as_reference():
    assert sorted(S.ALL_STRUCTURES) == sorted(r_S.ALL_STRUCTURES)


@pytest.mark.parametrize("name", sorted(S.ALL_STRUCTURES))
def test_get_matches_oracle(name, rng):
    keys, values = _data(rng)
    s = _build(S.ALL_STRUCTURES[name], keys, values)
    oracle = dict(zip(keys.tolist(), values.tolist()))
    for key in list(oracle)[:50]:
        assert s.get(key) == oracle[key], name
    for miss in range(10**7, 10**7 + 20):
        assert s.get(miss) is None, name


@pytest.mark.parametrize("name", sorted(S.ALL_STRUCTURES))
def test_range_get_matches_oracle(name, rng):
    keys, values = _data(rng)
    s = _build(S.ALL_STRUCTURES[name], keys, values)
    oracle = dict(zip(keys.tolist(), values.tolist()))
    for lo in (0, 1000, 5000):
        hi = lo + 1500
        want = sorted(v for k, v in oracle.items() if lo <= k < hi)
        assert sorted(s.range_get(lo, hi)) == want, name


@pytest.mark.parametrize("name", sorted(S.ALL_STRUCTURES))
def test_update_matches_oracle(name, rng):
    keys, values = _data(rng)
    s = _build(S.ALL_STRUCTURES[name], keys, values)
    for i, key in enumerate(keys[:20].tolist()):
        assert s.update(key, i)
        assert s.get(key) == i, name
    assert not s.update(10**9, 1)


@pytest.mark.parametrize("name", sorted(S.ALL_STRUCTURES))
def test_answers_match_reference(name, rng):
    """The same data, the same operations: the port's structure and the
    reference's answer identically (gets, misses, ranges, updates)."""
    keys, values = _data(rng)
    port = _build(S.ALL_STRUCTURES[name], keys, values)
    ref = _build(r_S.ALL_STRUCTURES[name], keys, values)
    probes = np.concatenate([keys[:64], rng.integers(0, 10**5, 64)])
    for key in probes.tolist():
        assert port.get(key) == ref.get(key)
    for lo in (0, 333, 4000):
        assert port.range_get(lo, lo + 900) == ref.range_get(lo, lo + 900)
    for i, key in enumerate(probes[::7].tolist()):
        assert port.update(key, i) == ref.update(key, i)
        assert port.get(key) == ref.get(key)


@given(st.lists(st.integers(min_value=0, max_value=10**6), min_size=1,
                max_size=300, unique=True),
       st.sampled_from(sorted(S.ALL_STRUCTURES)))
@settings(max_examples=40, deadline=None)
def test_structures_property(keys, name):
    keys = np.asarray(keys, np.int64)
    values = keys * 7 + 1
    s = _build(S.ALL_STRUCTURES[name], keys, values)
    probe = keys[len(keys) // 2]
    assert s.get(int(probe)) == int(probe) * 7 + 1
    lo, hi = int(keys.min()), int(keys.max()) + 1
    assert sorted(s.range_get(lo, hi)) == sorted(values.tolist())


def test_measure_workload_runs(rng):
    keys = rng.permutation(5000).astype(np.int64)
    out = S.measure_workload(S.BPlusTree(), keys, keys.copy(),
                             queries=keys[:100])
    assert out["bulk_load_s"] > 0 and out["per_query_s"] > 0
    assert set(out) == set(r_S.measure_workload(
        r_S.BPlusTree(), keys, keys.copy(), queries=keys[:100]))


# ---------------------------------------------------------------------------
# Design-space accounting (paper §2, Eq. 1-4): exactly the reference's
# ---------------------------------------------------------------------------
def test_design_space_summary_equals_reference():
    assert p_ds.summary() == r_ds.summary()
    assert p_ds.INVALID_COMBINATION_FACTOR == r_ds.INVALID_COMBINATION_FACTOR


@pytest.mark.parametrize("keys", [1.0, 1e3, 1e7, 1e15, 1e30])
@pytest.mark.parametrize("page,fanout", [(4096, 20), (256, 2), (65536, 128)])
def test_design_space_cardinalities_equal_reference(keys, page, fanout):
    assert p_ds.element_cardinality() == r_ds.element_cardinality()
    for k in (1, 2, 3):
        assert p_ds.standard_design_cardinality(k) == \
            r_ds.standard_design_cardinality(k)
        assert p_ds.fixed_library_cardinality(fanout, k) == \
            r_ds.fixed_library_cardinality(fanout, k)
    assert p_ds.polymorphic_design_cardinality(keys, page, fanout) == \
        r_ds.polymorphic_design_cardinality(keys, page, fanout)


def test_design_space_headline_numbers():
    """The paper's numbers: |E| ~ 1e16-1e17 elements, ~1e32-1e35 two-element
    structures, > 1e100 polymorphic designs for 1e15 keys."""
    s = p_ds.summary()
    assert 16.0 <= s["element_cardinality_log10"] < 18.0
    assert math.isclose(s["standard_two_element_log10"],
                        2 * s["element_cardinality_log10"])
    assert s["polymorphic_1e15_keys_log10"] > 100.0
    assert s["fixed_library_5_two_element"] == 25
