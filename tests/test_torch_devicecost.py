"""Port vs reference: the fused engine (devicecost) on the plain path.

On the CPU kernel K0's wrapper takes its plain PyTorch version
(``bank_predict`` + a segment sum), so these tests hold the port's fused
frontier and sweep scoring against the reference's fused engine
at rtol 1e-6, plus the port's own contracts: chunked == unchunked, the
real-record cuts equal the reference's padded layout bit for bit, a
retained sweep stays device-resident, a what-if-hardware swap adds no
kernel specialisation, ``shard=True`` equals the flat call, and
plain-path scoring launches no kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batchcost as r_batch, devicecost as r_dc
from repro.core import elements as r_el
from repro.core import hardware as r_hw, models as r_models
from repro.core import synthesis as r_syn, whatif as r_wi
from repro_torch import runtime
from repro_torch.core import batchcost as p_batch, devicecost as p_dc
from repro_torch.core import elements as p_el, hardware as p_hw
from repro_torch.core import synthesis as p_syn, templatecost as p_tc
from repro_torch.core import whatif as p_wi
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.testing import faults

MIX = {"get": 10.0, "update": 5.0}


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _specs(el):
    return [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list(),
            el.spec_btree(fanout=40), el.spec_btree(fanout=10)]


def _as_port(hw_ref):
    return p_hw.profile_from_arrays(hw_ref.name, {
        name: (m.kind, dict(m.params), m.x_range)
        for name, m in hw_ref.models.items()})


def _knn_pair(n_points):
    """hw1 with quicksort and random access as k-NN models (the
    reference's ``fit("knn")`` just stores the points)."""
    xs = np.logspace(1, 11, n_points)
    ys = 2e-9 * xs * np.log(xs) + 1e-8
    ref = r_hw.hw1()
    models = dict(ref.models)
    for name in ("quicksort", "random_memory_access"):
        models[name] = r_models.fit("knn", xs, ys)
    ref = r_hw.HardwareProfile("HW1+knn", models)
    return ref, _as_port(ref)


def _sig2d_pair():
    x = np.tile(np.logspace(2, 6, 20), 4)
    m_in = np.repeat([1, 2, 3, 4], 20)
    y = (1e-8 / (1 + np.exp(-(np.log(x + 1.0) - 8.0)))) * m_in
    ref = r_hw.HardwareProfile("HW1+2d", dict(r_hw.hw1().models))
    ref.models["bloom_probe_multiply_shift"] = r_models.fit2d_sigmoids(
        x, m_in, y)
    return ref, _as_port(ref)


def _pair(profile):
    if profile == "knn":
        return _knn_pair(12)
    if profile == "knn-small":
        return _knn_pair(3)
    if profile == "sigmoids2d":
        return _sig2d_pair()
    return getattr(r_hw, profile)(), getattr(p_hw, profile)()


@pytest.mark.parametrize("profile", ["hw1", "hw2", "knn", "knn-small",
                                     "sigmoids2d"])
def test_score_frontier_matches_reference(profile):
    ref_hw, port_hw = _pair(profile)
    specs_r = _specs(r_el) * 8 + [r_wi.add_bloom_filters(r_el.spec_btree())]
    specs_p = _specs(p_el) * 8 + [p_wi.add_bloom_filters(p_el.spec_btree())]
    want = r_batch.pack_frontier(specs_r, r_syn.Workload(n_entries=500_000),
                                 MIX).score(ref_hw)
    got = p_batch.pack_frontier(specs_p, p_syn.Workload(n_entries=500_000),
                                MIX).score(port_hw)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert p_dc.device_table(port_hw).has_knn == profile.startswith("knn")


@pytest.mark.parametrize("profile", ["hw3", "knn"])
def test_score_sweep_matches_reference(profile):
    ref_hw, port_hw = _pair(profile)
    fractions = np.linspace(0.0, 1.0, 6)
    want = r_batch.cost_sweep(_specs(r_el) * 3,
                              [r_syn.Workload(n_entries=2_000_000)] * 6,
                              ref_hw, r_wi.read_fraction_mixes(fractions))
    got = p_batch.cost_sweep(_specs(p_el) * 3,
                             [p_syn.Workload(n_entries=2_000_000)] * 6,
                             port_hw, p_wi.read_fraction_mixes(fractions))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["frontier", "sweep"])
def test_chunked_scoring_matches_unchunked(monkeypatch, kind):
    hw = p_hw.hw1()
    w = p_syn.Workload(n_entries=500_000)
    if kind == "frontier":
        packed = p_batch.pack_frontier(_specs(p_el) * 40, w, MIX)
    else:
        packed = p_batch.pack_sweep(_specs(p_el) * 40, [w] * 3,
                                    p_wi.read_fraction_mixes([0.1, 0.5, 1]))
    full = packed.score(hw)
    monkeypatch.setattr(p_dc, "_MAX_FUSED_RECORDS", 256)
    object.__setattr__(packed, "_f32", None)     # drop the padded cache
    chunked = packed.score(hw)
    # chunks end on design boundaries: every design is reduced as in the
    # resident layout
    np.testing.assert_array_equal(chunked, full)


@pytest.mark.parametrize("kind", ["frontier", "sweep"])
@pytest.mark.parametrize("profile", ["hw1", "knn"])
def test_real_record_cuts_match_the_padded_layout(kind, profile):
    """K0 reads real records only: on the reference's padded layout (pow2
    bucket, pad rows of weight 0 whose tiles belong to the last design),
    the port's real-record cuts give totals bit-identical to the old cuts
    that handed the pad tiles to the last design."""
    _, hw = _pair(profile)
    w = p_syn.Workload(n_entries=500_000)
    if kind == "frontier":
        packed = p_batch.pack_frontier(_specs(p_el) * 9, w, MIX)
        f0, n_seg = packed, packed.n_segments
        sizes, weights = packed.sizes[None], packed.weights[None]
    else:
        packed = p_batch.pack_sweep(_specs(p_el) * 9, [w] * 3,
                                    p_wi.read_fraction_mixes([0.1, 0.5, 1]))
        f0, n_seg = packed.frontiers[0], packed.n_designs
        sizes = np.stack([f.sizes for f in packed.frontiers])
        weights = np.stack([f.weights for f in packed.frontiers])
    bucket = r_dc._pow2(len(f0.ids), 16)
    assert bucket > len(f0.ids)
    ids, sizes, weights, tiles = r_dc.pad_sweep(
        np.asarray(f0.ids, np.int32), sizes, weights,
        np.asarray(f0.tile_segments, np.int32), bucket)
    _, old_cuts = p_tc.segment_ranges(tiles, n_seg, n_seg)
    new_cuts = p_dc.segment_cuts(f0.tile_segments, n_seg)
    assert old_cuts[-1] == bucket // p_dc.TILE
    assert new_cuts[-1] == len(f0.tile_segments)
    table = p_dc.device_table(hw)
    args = [torch.as_tensor(a) for a in (ids, sizes, weights)]
    old = p_dc.bank_score_plain(table.banks, *args,
                                torch.as_tensor(old_cuts.astype(np.int32)),
                                table.has_knn)
    new = p_dc.bank_score_plain(table.banks, *args,
                                torch.as_tensor(new_cuts), table.has_knn)
    assert torch.equal(old, new)
    got = packed.score(hw)
    np.testing.assert_allclose(got.reshape(new.shape), new.double().numpy(),
                               rtol=1e-6)


def test_large_sweep_stays_resident_and_repeats_copy_nothing(monkeypatch):
    """A sweep larger than one of the reference's 2^18-cell chunks is laid
    out on the device by its first score and scored in one K0 call; a
    repeat score makes no host->device copy."""
    hw = p_hw.hw1()
    sweep = p_batch.pack_sweep(
        _specs(p_el) * 60, [p_syn.Workload(n_entries=500_000)] * 64,
        p_wi.read_fraction_mixes(np.linspace(0.0, 1.0, 64)))
    assert len(sweep.frontiers[0].ids) > r_dc.sweep_chunk(64)
    calls, copies = [], []
    score, to_device = p_dc.bank_score, p_dc._to_device
    monkeypatch.setattr(p_dc, "bank_score",
                        lambda *a: calls.append(1) or score(*a))
    first = sweep.score(hw)
    laid = sweep._f32[runtime.device()]
    assert laid.resident and len(calls) == 1
    assert all(isinstance(a, torch.Tensor) for a in laid.arrays)
    monkeypatch.setattr(p_dc, "_to_device",
                        lambda *a: copies.append(1) or to_device(*a))
    np.testing.assert_array_equal(sweep.score(hw), first)
    assert copies == [] and len(calls) == 2
    np.testing.assert_allclose(first, sweep.score(hw, engine="grouped"),
                               rtol=1e-6)


def test_hardware_swap_adds_no_specialisation():
    packed = p_batch.pack_frontier(_specs(p_el), p_syn.Workload(
        n_entries=500_000), MIX)
    packed.score(p_hw.hw1())
    before = p_dc.specialisation_count()
    totals = {hw.name: packed.score(hw)
              for hw in (p_hw.hw2(), p_hw.hw3(), p_hw.hw1())}
    assert p_dc.specialisation_count() == before
    assert not np.allclose(totals["HW2"], totals["HW3"])
    p_wi.what_if_hardware(p_el.spec_btree(), p_syn.Workload(n_entries=10**6),
                          p_hw.hw1(), p_hw.hw3(), MIX)
    before = p_dc.specialisation_count()
    ans = p_wi.what_if_hardware(p_el.spec_btree(),
                                p_syn.Workload(n_entries=10**6),
                                p_hw.hw2(), p_hw.hw3(), MIX)
    assert p_dc.specialisation_count() == before
    assert ans.beneficial
    # a knn profile needs the top-4 specialisation (one more at most)
    _, knn_hw = _knn_pair(12)
    packed.score(knn_hw)
    assert p_dc.specialisation_count() <= before + 1
    assert (True, 4, 16) in p_dc._SPECIALISATIONS


def test_shard_true_raises():
    """``shard=True`` raised until multi-device scoring was ported; now it
    splits the grid (on one device too) and equals the flat call bit for
    bit, through the packed objects and through ``score_sweep``."""
    hw = p_hw.hw1()
    w = p_syn.Workload(n_entries=500_000)
    packed = p_batch.pack_frontier(_specs(p_el), w, MIX)
    np.testing.assert_array_equal(packed.score(hw, shard=True),
                                  packed.score(hw, shard=False))
    sweep = p_batch.pack_sweep(_specs(p_el), [w] * 2)
    np.testing.assert_array_equal(sweep.score(hw, shard=True),
                                  sweep.score(hw, shard=False))
    ds = sweep._sweep_arrays(runtime.device())
    np.testing.assert_array_equal(p_dc.score_sweep(ds, hw, shard=True),
                                  p_dc.score_sweep(ds, hw, shard=False))
    np.testing.assert_array_equal(packed.score(hw, shard=False),
                                  packed.score(hw))


def test_plain_path_launches_no_kernel():
    reset_launch_counts()
    p_batch.cost_many(_specs(p_el), p_syn.Workload(n_entries=10_000),
                      p_hw.hw1())
    assert launch_counts().get("bank_score", 0) == 0
    table = p_dc.device_table(p_hw.hw1())
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        p_dc.bank_score(table.banks, meta, meta[None].float(),
                        meta[None].float(), meta[:2], False)


def test_missing_model_and_stale_tables():
    w = p_syn.Workload(n_entries=500_000)
    partial = p_hw.HardwareProfile("partial", {
        k: m for k, m in p_hw.hw1().models.items() if "write" not in k})
    with pytest.raises(KeyError, match="write"):
        p_batch.cost_many(_specs(p_el), w, partial, MIX)
    hw = p_hw.hw1()
    t1 = p_dc.device_table(hw)
    assert p_dc.device_table(hw) is t1
    t2 = p_dc.device_table(p_hw.hw3())
    assert {k: v.shape for k, v in t1.banks.items()} == \
        {k: v.shape for k, v in t2.banks.items()}
    derived = dataclasses.replace(hw, name="HW1-as-HW3",
                                  models=p_hw.hw3().models)
    fused = p_batch.cost_many(_specs(p_el), w, derived, MIX)
    grouped = p_batch.cost_many(_specs(p_el), w, derived, MIX,
                                engine="grouped")
    np.testing.assert_allclose(fused, grouped, rtol=1e-6)


def test_corrupt_banks_surface_as_nan_until_rebuilt():
    hw = p_hw.hw1()
    packed = p_batch.pack_frontier(_specs(p_el), p_syn.Workload(
        n_entries=500_000), MIX)
    p_dc.invalidate_table(hw)
    plan = faults.FaultPlan(rules=[faults.FaultRule(
        "devicecost.banks", kind="corrupt", rate=1.0, max_fires=1)])
    with plan.activate():
        assert not np.isfinite(packed.score(hw)).any()
    assert not np.isfinite(packed.score(hw)).any()   # cached poisoned table
    p_dc.invalidate_table(hw)
    assert np.isfinite(packed.score(hw)).all()


def test_bank_predict_is_differentiable():
    table = p_dc.device_table(p_hw.hw3())
    ids = torch.arange(4, dtype=torch.int32)
    x = torch.tensor([10.0, 1e3, 1e5, 1e7], requires_grad=True)
    p_dc.bank_predict(table.banks, ids, x, False).sum().backward()
    assert torch.isfinite(x.grad).all()
