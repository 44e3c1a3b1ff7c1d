"""Port vs reference: sharded scoring and slot-routed serving (the twin
of ``tests/test_sharded.py``) on the CPU.

The contract: sharded sweeps and frontiers (design ranges cut by
``split``, the one partition) equal the flat call bit for bit — on resident
grids and on grids past the device-memory ceiling, which stream through
in chunks — so argmins through ``design_beam``/``whatif.workload_sweep``
are identical, repeat sharded scores and hardware swaps ask for no new
K0 specialisation, and the serving shard pool partitions a window
across several slots while keeping the deadline semantics.  The
reference runs its multi-device cases under forced XLA host devices;
here a device list of ``["cpu"] * n`` (``devicecost.shard_devices``
patched, ``ScoringShardPool(devices=...)``) takes their place, for n in
2 and 8.
Snapshots carry none of the per-device layouts.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from repro.core import batchcost as r_batch, elements as r_el
from repro.core import hardware as r_hw
from repro.core.synthesis import Workload as RWorkload
from repro_torch import runtime
from repro_torch.core import batchcost, devicecost, elements as el, memo
from repro_torch.core import whatif
from repro_torch.core.autocomplete import design_beam
from repro_torch.core.batchcost import pack_frontier, pack_sweep
from repro_torch.core.hardware import HardwareProfile, hw1, hw3
from repro_torch.core.models import FittedModel
from repro_torch.core.synthesis import Workload
from repro_torch.serving import DesignCalculatorService, ScoringShardPool
from repro_torch.serving.admission import DeadlineExceeded

BASE = Workload(n_entries=120_000, n_queries=100)
MIX = {"get": 60.0, "range_get": 20.0, "update": 20.0}


def _specs(el=el):
    return [el.spec_btree(), el.spec_array(1), el.spec_hash_table(),
            el.spec_skip_list(), el.spec_trie(), el.spec_linked_list(),
            el.spec_sorted_array(1), el.spec_csb_tree()]


def _workloads(n=5, base=BASE):
    return [dataclasses.replace(base, zipf_alpha=0.3 * i)
            for i in range(n)]


def _knn_hw():
    """hw1 with random access as a k-NN model (K0's top-4 path)."""
    base = hw1()
    xs = np.logspace(0.0, 11.0, 12).astype(np.float32)
    ys = base.models["random_memory_access"].predict(xs).astype(np.float32)
    models = dict(base.models)
    models["random_memory_access"] = FittedModel(
        "knn", {"x": xs, "y": ys}, (float(xs.min()), float(xs.max())))
    return HardwareProfile("HW1+knn", models)


def _fresh(packed):
    """The same packed grid without any memoized layout."""
    if isinstance(packed, batchcost.PackedSweep):
        return batchcost.PackedSweep(packed.points, packed.n_designs,
                                     tuple(_fresh(f)
                                           for f in packed.frontiers))
    return dataclasses.replace(packed)


@pytest.fixture(autouse=True)
def _cpu_and_reset():
    with runtime.use_device("cpu"):
        yield
    devicecost.set_shard_threshold(None)


@pytest.fixture()
def slots(monkeypatch):
    """``slots(n)``: the split paths see ``n`` devices, all the CPU."""
    def pin(n):
        monkeypatch.setattr(devicecost, "shard_devices",
                            lambda home=None: (torch.device("cpu"),) * n)
    return pin


@pytest.fixture()
def hw_analytical():
    return hw1()


# ---------------------------------------------------------------------------
# The shard threshold knob
# ---------------------------------------------------------------------------
def test_shard_threshold_override_wins():
    devicecost.set_shard_threshold(123)
    assert devicecost.shard_threshold() == 123
    devicecost.set_shard_threshold(None)
    assert devicecost.shard_threshold() == devicecost._MAX_FUSED_RECORDS


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_default_threshold_keeps_auto_flat(slots, hw_analytical, n_devices):
    """Until a run on several cards measures the split, ``shard=None``
    scores a grid below the resident ceiling flat, however many devices
    there are: no part is cut."""
    slots(n_devices)
    packed = _fresh(pack_frontier(_specs(), BASE, MIX))
    sweep = _fresh(pack_sweep(_specs(), _workloads(), [MIX] * 5))
    for obj in (packed, sweep):
        assert np.array_equal(obj.score(hw_analytical),
                              obj.score(hw_analytical, shard=False))
        assert "_parts" not in vars(obj)


def test_single_device_never_shards_by_default():
    assert devicecost.shard_devices() == (torch.device("cpu"),)
    devicecost.set_shard_threshold(1)
    assert devicecost.shard_count(8, 10**6, None) == 0
    assert devicecost.shard_count(8, 10**6, True) == 1


def test_shard_devices_and_count(slots):
    slots(3)
    assert devicecost.shard_devices() == (torch.device("cpu"),) * 3
    assert devicecost.shard_count(5, 100, True) == 3
    assert devicecost.shard_count(2, 100, True) == 2
    assert devicecost.shard_count(5, 100, False) == 0
    assert devicecost.shard_count(0, 100, True) == 0
    devicecost.set_shard_threshold(10**9)
    assert devicecost.shard_count(5, 100, None) == 0
    devicecost.set_shard_threshold(100)
    assert devicecost.shard_count(5, 100, None) == 3
    assert devicecost.shard_count(5, 99, None) == 0


# ---------------------------------------------------------------------------
# Split/merge partitions (the shard pool's primitive)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("profile", ["hw1", "knn"])
def test_frontier_split_merge_bit_identical(profile):
    hw = hw1() if profile == "hw1" else _knn_hw()
    packed = pack_frontier(_specs(), BASE, MIX)
    whole = packed.score(hw, shard=False)
    for n_parts in (1, 2, 3, len(_specs()), 64):
        parts = packed.split(n_parts)
        assert sum(p.n_segments for p in parts) == packed.n_segments
        merged = np.concatenate(
            [p.score(hw, shard=False) for p in parts])
        assert np.array_equal(merged, whole)


@pytest.mark.parametrize("profile", ["hw1", "knn"])
def test_sweep_split_merge_bit_identical(profile):
    hw = hw1() if profile == "hw1" else _knn_hw()
    sweep = pack_sweep(_specs(), _workloads(), [MIX] * 5)
    whole = sweep.score(hw, shard=False)
    for n_parts in (2, 3, 64):
        parts = sweep.split(n_parts)
        assert all(p.rectangular for p in parts)   # ids stay shared
        merged = np.concatenate(
            [p.score(hw, shard=False) for p in parts], axis=1)
        assert np.array_equal(merged, whole)
    assert sweep.split(3) == sweep.split(3)        # memoized per count


def test_sharded_paths_bit_identical_here(hw_analytical):
    """shard=True on the one default device matches the flat call."""
    packed = pack_frontier(_specs(), BASE, MIX)
    assert np.array_equal(packed.score(hw_analytical, shard=True),
                          packed.score(hw_analytical, shard=False))
    sweep = pack_sweep(_specs(), _workloads(), [MIX] * 5)
    assert np.array_equal(sweep.score(hw_analytical, shard=True),
                          sweep.score(hw_analytical, shard=False))
    one_row = pack_sweep(_specs(), [BASE], [MIX])
    assert np.array_equal(one_row.score(hw_analytical, shard=True),
                          one_row.score(hw_analytical, shard=False))


def test_pool_degenerate_is_plain_score(hw_analytical):
    pool = ScoringShardPool(1)
    assert pool.n_shards == 1 and pool.devices == [torch.device("cpu")]
    packed = pack_frontier(_specs(), BASE, MIX)
    totals, used = pool.score_frontier(packed, hw_analytical)
    assert used == 1
    assert np.array_equal(totals, packed.score(hw_analytical))
    sweep = pack_sweep(_specs(), _workloads(), [MIX] * 5)
    grid, used = pool.score_sweep(sweep, hw_analytical)
    assert used == 1
    assert np.array_equal(grid, sweep.score(hw_analytical))
    pool.close()


def test_pool_abort_when_probe_reports_dead(hw_analytical):
    pool = ScoringShardPool(1)
    packed = pack_frontier(_specs(), BASE, MIX)
    totals, used = pool.score_frontier(packed, hw_analytical,
                                       before_dispatch=lambda i: False)
    assert totals is None and used == 0
    pool.close()


def test_pool_slots_clamp_and_repeat():
    assert ScoringShardPool(devices=["cpu"] * 4).n_shards == 4
    assert ScoringShardPool(2, devices=["cpu"] * 4).n_shards == 2
    assert ScoringShardPool(9, devices=["cpu"] * 3).n_shards == 3
    assert ScoringShardPool(0, devices=["cpu"] * 3).n_shards == 1
    with pytest.raises(ValueError):
        ScoringShardPool(devices=[])
    health = ScoringShardPool(devices=["cpu"] * 2).device_health()
    assert [h["slot"] for h in health] == [0, 1]
    assert all(h["device"] == "cpu" and h["state"] == "ok"
               for h in health)


# ---------------------------------------------------------------------------
# The parity matrix: several slots of the CPU in place of several devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_parity_under_devices(slots, n_devices):
    hw = hw1()
    specs, workloads = _specs(), _workloads()
    slots(n_devices)
    devicecost.set_shard_threshold(1)   # every auto decision shards

    packed = pack_frontier(specs, BASE, MIX)
    flat = packed.score(hw, shard=False)
    assert np.array_equal(packed.score(hw, shard=True), flat)
    assert np.array_equal(packed.score(hw), flat)   # auto
    n_parts = min(n_devices, len(specs))
    assert n_parts in packed.__dict__["_parts"]   # memoized, may be shared
    assert all(torch.device("cpu") in part._f32
               for part in packed.split(n_parts))

    sweep = pack_sweep(specs, workloads, [MIX] * len(workloads))
    grid = sweep.score(hw, shard=False)
    rows = sweep.score(hw, shard=True)
    assert np.array_equal(rows, grid)
    assert np.array_equal(np.argmin(rows, axis=1), np.argmin(grid, axis=1))
    np.testing.assert_allclose(rows, sweep.score(hw, engine="grouped"),
                               rtol=1e-6)
    assert n_parts in sweep._parts

    # no new K0 specialisation on repeat sharded scores and swaps
    sweep.score(hw3(), shard=True)
    before = devicecost.specialisation_count()
    for _ in range(3):
        assert np.array_equal(sweep.score(hw, shard=True), grid)
        sweep.score(hw3(), shard=True)
    packed.score(hw, shard=True)
    assert devicecost.specialisation_count() == before

    # single-row sweeps split their designs, same grid
    one_row = pack_sweep(specs, [BASE], [MIX])
    assert np.array_equal(one_row.score(hw, shard=True),
                          one_row.score(hw, shard=False))

    # the shard pool partitions and merges bit-identically
    pool = ScoringShardPool(devices=["cpu"] * n_devices,
                            min_cells_per_shard=1)
    try:
        assert pool.n_shards == n_devices
        totals, used = pool.score_frontier(packed, hw)
        assert used > 1
        assert np.array_equal(totals, flat)
        pooled, used = pool.score_sweep(sweep, hw)
        assert used > 1
        assert np.array_equal(pooled, grid)
    finally:
        pool.close()

    # identical argmins through the public search/sweep surfaces
    devicecost.set_shard_threshold(devicecost._MAX_FUSED_RECORDS)
    answer_flat = whatif.workload_sweep(specs, workloads, hw,
                                        [MIX] * len(workloads))
    beam_flat = design_beam(BASE, hw, MIX, max_rounds=2)
    batchcost.clear_caches()
    devicecost.set_shard_threshold(1)
    answer_sharded = whatif.workload_sweep(specs, workloads, hw,
                                           [MIX] * len(workloads))
    beam_sharded = design_beam(BASE, hw, MIX, max_rounds=2)
    assert np.array_equal(answer_sharded.totals, answer_flat.totals)
    assert beam_sharded["design"] == beam_flat["design"]
    assert beam_sharded["cost_s"] == beam_flat["cost_s"]


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("profile", ["hw1", "knn"])
def test_sharded_parity_on_chunked_grids(monkeypatch, slots, n_devices,
                                        profile):
    """Past the device-memory ceiling a grid streams through in chunks
    that end on design boundaries, so the flat call, its split and the
    pool's parts all equal the resident grid bit for bit."""
    hw = hw1() if profile == "hw1" else _knn_hw()
    specs = _specs() * 12
    sweep = pack_sweep(specs, _workloads(6), [MIX] * 6)
    packed = pack_frontier(specs, BASE, MIX)
    resident_grid = sweep.score(hw, shard=False)
    resident_totals = packed.score(hw, shard=False)
    n_records = len(packed.ids)
    # a few chunks, each several designs long
    monkeypatch.setattr(devicecost, "_MAX_FUSED_RECORDS", n_records // 3)
    sweep, packed = _fresh(sweep), _fresh(packed)
    assert not sweep._sweep_arrays("cpu").resident
    assert not packed._device_sweep("cpu").resident
    assert len(devicecost.chunk_bounds(
        packed._device_sweep("cpu").cuts,
        devicecost.sweep_chunk(1) // devicecost.TILE)) >= 3
    assert np.array_equal(sweep.score(hw, shard=False), resident_grid)
    assert np.array_equal(packed.score(hw, shard=False), resident_totals)
    slots(n_devices)
    assert np.array_equal(sweep.score(hw, shard=True), resident_grid)
    assert np.array_equal(packed.score(hw, shard=True), resident_totals)
    assert not any(layout.resident for part in sweep.split(n_devices)
                   for layout in part._f32.values())
    pool = ScoringShardPool(devices=["cpu"] * n_devices,
                            min_cells_per_shard=1)
    try:
        grid, used = pool.score_sweep(sweep, hw)
        assert used == n_devices
        assert np.array_equal(grid, resident_grid)
        totals, used = pool.score_frontier(packed, hw)
        assert used == n_devices
        assert np.array_equal(totals, resident_totals)
    finally:
        pool.close()


def test_chunks_end_on_design_boundaries():
    cuts = np.asarray([0, 2, 2, 5, 6, 20, 21], np.int32)
    assert devicecost.chunk_bounds(cuts, 4) == \
        [(0, 2), (2, 6), (6, 20), (20, 21)]
    assert devicecost.chunk_bounds(cuts, 100) == [(0, 21)]
    assert devicecost.chunk_bounds(np.zeros(3, np.int32), 4) == []


def test_sharded_matches_reference_sharded(slots):
    """The port's split scoring against the reference's pmap path on the
    same questions: 1e-6 relative, identical argmins."""
    slots(3)
    p_sweep = pack_sweep(_specs(), _workloads(), [MIX] * 5)
    r_sweep = r_batch.pack_sweep(
        _specs(r_el), _workloads(base=RWorkload(n_entries=120_000,
                                                n_queries=100)), [MIX] * 5)
    got = p_sweep.score(hw1(), shard=True)
    want = r_sweep.score(r_hw.hw1(), shard=True)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(np.argmin(got, 1), np.argmin(want, 1))
    got = pack_frontier(_specs(), BASE, MIX).score(hw3(), shard=True)
    want = r_batch.pack_frontier(
        _specs(r_el), RWorkload(n_entries=120_000, n_queries=100),
        MIX).score(r_hw.hw3(), shard=True)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _tensors_in(obj, seen=None) -> int:
    """Tensors and layouts reachable from ``obj`` through containers and
    object attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, (torch.Tensor, devicecost.DeviceSweep)):
        return 1
    if isinstance(obj, dict):
        return sum(_tensors_in(k, seen) + _tensors_in(v, seen)
                   for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(_tensors_in(v, seen) for v in obj)
    if hasattr(obj, "__dict__"):
        return _tensors_in(vars(obj), seen)
    return 0


def test_snapshot_strips_every_per_device_layout(tmp_path, slots,
                                                hw_analytical):
    batchcost.clear_caches()
    slots(2)
    sweep = pack_sweep(_specs(), _workloads(), [MIX] * 5)
    packed = pack_frontier(_specs(), BASE, MIX)
    for obj in (sweep, packed):
        obj.score(hw_analytical, shard=True)
        obj.score(hw_analytical, shard=False)
        for part in obj.split(2):
            part.score(hw_analytical)
    assert {"_f32", "_parts"} <= set(vars(sweep))
    path = tmp_path / "snap.pkl"
    assert memo.snapshot_caches(str(path)) > 0
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    assert _tensors_in(payload) == 0
    assert memo.restore_caches(str(path)) > 0


def test_service_routes_across_scoring_shards():
    """A mixed window served across two slots: bit-identical answers,
    shard dispatches counted, deadlines intact."""
    hw = hw1()
    specs, workloads = _specs(), _workloads()
    mixes = [MIX] * len(workloads)
    oracle = whatif.workload_sweep(specs, workloads, hw, mixes)
    service = DesignCalculatorService(
        [hw], scoring_devices=["cpu", "cpu"], shard_min_cells=1,
        window_s=0.02)
    try:
        futures = [service.submit_sweep(specs, workloads, hw, mixes)
                   for _ in range(2)]
        futures.append(service.submit_design(
            el.spec_btree(), el.spec_array(1), BASE, hw, MIX))
        answers = [f.result(timeout=120) for f in futures]
        for sweep_answer in answers[:2]:
            assert np.array_equal(sweep_answer.totals, oracle.totals)
            assert sweep_answer.engine == "fused"
        direct = whatif.what_if_design(
            el.spec_btree(), el.spec_array(1), BASE, hw, MIX)
        np.testing.assert_allclose(answers[2].baseline_seconds,
                                   direct.baseline_seconds, rtol=1e-12)
        stats = service.stats()
        assert stats["shard_dispatches"] >= 2
        doomed = service.submit_sweep(specs, workloads, hw, mixes,
                                      deadline_s=1e-9)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=120)
    finally:
        service.stop()


def test_concurrent_first_scores_build_banks_once(monkeypatch):
    """Slots that start together find a profile's table stale at once:
    the table is built once, and each other device gets one replica."""
    import sys
    import threading
    hw = dataclasses.replace(hw3(), name="HW3-stress")
    builds = []
    build = devicecost.build_table
    monkeypatch.setattr(devicecost, "build_table",
                        lambda *a, **k: builds.append(1) or build(*a, **k))
    n_threads = 16
    barrier = threading.Barrier(n_threads)
    tables = [None] * n_threads

    def first_score(i):
        barrier.wait(timeout=60)
        tables[i] = devicecost.device_table(hw, ("cpu", "cpu:0")[i % 2])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_score, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert builds == [1]
    assert len({id(t) for t in tables}) == 2      # the table, one replica
    packed = pack_frontier(_specs(), BASE, MIX)
    assert np.array_equal(packed.score(hw, device="cpu:0"),
                          packed.score(hw, device="cpu"))
