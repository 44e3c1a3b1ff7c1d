"""Port vs reference: template-vectorized packing of a depth-2 frontier.

``pack_frontier`` / ``pack_sweep`` are numpy in both packages.  Model ids
are interned separately in each process, so ids compare as the Level-2
model names they stand for; ``tile_segments`` must be identical and
``sizes``/``weights`` equal to rtol 1e-12.
"""
import numpy as np
import pytest

from repro.core import autocomplete as r_ac, batchcost as r_batch
from repro.core import devicecost as r_dc, whatif as r_wi
from repro.core import synthesis as r_syn
from repro_torch import runtime
from repro_torch.core import autocomplete as p_ac, batchcost as p_batch
from repro_torch.core import devicecost as p_dc, whatif as p_wi
from repro_torch.core import synthesis as p_syn


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _names(ids, names):
    return [names[i] for i in np.asarray(ids)]


def _assert_same_frontier(p, r):
    assert p.n_segments == r.n_segments
    assert _names(p.ids, p_dc._MODEL_NAMES) == \
        _names(r.ids, r_dc._MODEL_NAMES)
    np.testing.assert_array_equal(p.tile_segments, r.tile_segments)
    np.testing.assert_allclose(p.sizes, r.sizes, rtol=1e-12)
    np.testing.assert_allclose(p.weights, r.weights, rtol=1e-12)


@pytest.mark.parametrize("workload", [
    dict(n_entries=1_000_000),
    dict(n_entries=50_000, zipf_alpha=1.0, selectivity=0.05)])
@pytest.mark.parametrize("mix", [None, {"get": 70.0, "update": 30.0},
                                 {"range_get": 3.0, "bulk_load": 1.0}])
def test_pack_frontier_matches_reference(workload, mix):
    p_front = p_ac.enumerate_frontier((), max_depth=2)
    r_front = r_ac.enumerate_frontier((), max_depth=2)
    assert [s.describe() for s in p_front] == \
        [s.describe() for s in r_front]
    _assert_same_frontier(
        p_batch.pack_frontier(p_front, p_syn.Workload(**workload), mix),
        r_batch.pack_frontier(r_front, r_syn.Workload(**workload), mix))


def test_pack_sweep_matches_reference():
    fractions = np.linspace(0.0, 1.0, 5)
    p_front = p_ac.enumerate_frontier((), max_depth=2)
    r_front = r_ac.enumerate_frontier((), max_depth=2)
    p_sw = p_batch.pack_sweep(p_front, [p_syn.Workload(n_entries=300_000)] * 5,
                              p_wi.read_fraction_mixes(fractions))
    r_sw = r_batch.pack_sweep(r_front, [r_syn.Workload(n_entries=300_000)] * 5,
                              r_wi.read_fraction_mixes(fractions))
    assert p_sw.rectangular and r_sw.rectangular
    assert p_sw.n_points == r_sw.n_points and \
        p_sw.n_designs == r_sw.n_designs
    for p, r in zip(p_sw.frontiers, r_sw.frontiers):
        _assert_same_frontier(p, r)


def test_non_rectangular_sweep_matches_reference():
    """Points whose data size changes the level structure pack
    separately in both packages."""
    sizes = [1_000, 1_000_000, 50_000_000]
    p_front = p_ac.enumerate_frontier((), max_depth=2)
    r_front = r_ac.enumerate_frontier((), max_depth=2)
    p_sw = p_batch.pack_sweep(p_front, [p_syn.Workload(n_entries=n)
                                        for n in sizes])
    r_sw = r_batch.pack_sweep(r_front, [r_syn.Workload(n_entries=n)
                                        for n in sizes])
    assert p_sw.rectangular == r_sw.rectangular
    for p, r in zip(p_sw.frontiers, r_sw.frontiers):
        _assert_same_frontier(p, r)


def test_sweep_pad_layout_matches_reference():
    """The port's device layout is the reference's padded layout without
    its pad rows: the same records, and per-segment cuts that end at the
    last real tile.  The reference's pad rows (pow2 bucket, pad ids
    repeating a real model, pad tiles repeating the last segment) carry
    weight 0, so dropping them changes no total."""
    front = p_ac.enumerate_frontier((), max_depth=2)
    r_front = r_ac.enumerate_frontier((), max_depth=2)
    p_f = p_batch.pack_frontier(front, p_syn.Workload(n_entries=10_000))
    r_f = r_batch.pack_frontier(r_front, r_syn.Workload(n_entries=10_000))
    bucket = r_dc._pow2(len(r_f.ids), 16)
    r_pad = r_dc.pad_sweep(r_f.ids, r_f.sizes[None], r_f.weights[None],
                           r_f.tile_segments, bucket)
    laid = p_dc.to_device_sweep(p_f.ids, p_f.sizes[None], p_f.weights[None],
                                p_f.tile_segments, p_f.n_segments)
    n = len(p_f.ids)
    assert bucket > n and laid.resident
    ids, sizes, weights, cuts = (t.numpy() for t in laid.arrays)
    assert _names(ids, p_dc._MODEL_NAMES) == \
        _names(r_pad[0][:n], r_dc._MODEL_NAMES)
    np.testing.assert_array_equal(sizes, r_pad[1][:, :n])
    np.testing.assert_array_equal(weights, r_pad[2][:, :n])
    assert not r_pad[2][:, n:].any()
    assert (r_pad[3][n // p_dc.TILE:] == r_f.n_segments - 1).all()
    np.testing.assert_array_equal(
        cuts, np.searchsorted(r_pad[3][:n // p_dc.TILE],
                              np.arange(r_f.n_segments + 1)))
    assert cuts[-1] * p_dc.TILE == n
    # one launch holds a whole main sweep: W x R under the port's own
    # device-memory ceiling (the reference chunks at 2^18 cells)
    assert p_dc.sweep_chunk(64) == p_dc._MAX_FUSED_RECORDS // 64 >= \
        64 * r_dc.sweep_chunk(64)
    assert p_dc.TILE == r_dc.TILE
