"""Port vs reference: the scalar expert system (cost_workload), and the
port's own scalar/grouped 1e-9 contract.

Every paper spec of ``ALL_PAPER_SPECS`` is costed by both packages under
the same workloads, operation mixes and analytical profiles; totals must
agree to rtol 1e-6 (float32 Level-2 predictions, see
test_torch_models.py).  Inside the port, the grouped engine must match
the scalar path to 1e-9 relative, as the reference's does.
"""
import numpy as np
import pytest

from repro.core import elements as r_el, hardware as r_hw
from repro.core import synthesis as r_syn
from repro_torch import runtime
from repro_torch.core import batchcost as p_batch
from repro_torch.core import elements as p_el, hardware as p_hw
from repro_torch.core import synthesis as p_syn

WORKLOADS = [dict(n_entries=10_000), dict(n_entries=1_000_000),
             dict(n_entries=5_000_000, zipf_alpha=1.1, key_bytes=16,
                  value_bytes=32, selectivity=0.01)]
MIXES = [None, {"get": 50.0, "update": 50.0},
         {"range_get": 10.0, "get": 5.0}, {"bulk_load": 1.0}]


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _spec_args(name):
    return (1000,) if name in ("array", "sorted_array") else ()


@pytest.mark.parametrize("hw_name", ["hw1", "hw3"])
@pytest.mark.parametrize("w_idx", range(len(WORKLOADS)))
def test_scalar_cost_matches_reference(hw_name, w_idx):
    assert list(p_el.ALL_PAPER_SPECS) == list(r_el.ALL_PAPER_SPECS)
    r_hw_, p_hw_ = getattr(r_hw, hw_name)(), getattr(p_hw, hw_name)()
    r_w = r_syn.Workload(**WORKLOADS[w_idx])
    p_w = p_syn.Workload(**WORKLOADS[w_idx])
    for name in r_el.ALL_PAPER_SPECS:
        r_spec = r_el.ALL_PAPER_SPECS[name](*_spec_args(name))
        p_spec = p_el.ALL_PAPER_SPECS[name](*_spec_args(name))
        assert p_spec.describe() == r_spec.describe()
        for mix in MIXES:
            want = r_syn.cost_workload(r_spec, r_w, r_hw_, mix)
            got = p_syn.cost_workload(p_spec, p_w, p_hw_, mix)
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       err_msg=f"{name} {mix}")


def test_breakdowns_are_identical_records():
    """Synthesis is numpy/stdlib only: the record sequence (primitive,
    Level-2 model, size, count) is the reference's exactly."""
    w = dict(n_entries=1_000_000, zipf_alpha=0.8)
    for name in r_el.ALL_PAPER_SPECS:
        r_spec = r_el.ALL_PAPER_SPECS[name](*_spec_args(name))
        p_spec = p_el.ALL_PAPER_SPECS[name](*_spec_args(name))
        for op in ("get", "range_get", "update", "bulk_load"):
            r_cb = r_syn.synthesize_operation(op, r_spec, r_syn.Workload(**w))
            p_cb = p_syn.synthesize_operation(op, p_spec, p_syn.Workload(**w))
            assert [(r.level1, r.level2, r.size, r.count)
                    for r in p_cb.records] == \
                [(r.level1, r.level2, r.size, r.count) for r in r_cb.records]
            assert p_cb.format() == r_cb.format()


def test_paper_btree_example_exact():
    """The §3 cache-aware walk-through, as the reference asserts it."""
    spec = p_el.spec_btree(fanout=20, page=250)
    cb = p_syn.synthesize_get(spec, p_syn.Workload(n_entries=100_000))
    assert [round(r.size) for r in cb.records] == \
        [312, 152, 6552, 152, 1606552, 2000, 2000]


@pytest.mark.parametrize("mix_idx", range(len(MIXES)))
def test_scalar_and_grouped_agree_to_1e9(mix_idx):
    hw = p_hw.hw2()
    specs = [p_el.ALL_PAPER_SPECS[n](*_spec_args(n))
             for n in p_el.ALL_PAPER_SPECS]
    w = p_syn.Workload(n_entries=2_000_000, zipf_alpha=0.5)
    mix = MIXES[mix_idx]
    grouped = p_batch.cost_many(specs, w, hw, mix, engine="grouped")
    scalar = [p_syn.cost_workload(s, w, hw, mix) for s in specs]
    np.testing.assert_allclose(grouped, scalar, rtol=1e-9)
