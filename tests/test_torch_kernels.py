"""Port vs reference: the sorted-array, hash-table and log+bloom store
ops on the CPU (the kernels' plain versions), against the JAX ops run in
Pallas interpret mode and against the reference oracles, on the
parameter grids of tests/test_kernels.py.  Every result must be exactly
equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.bloom_probe import kernel as r_bp_kernel
from repro.kernels.bloom_probe import ops as r_bp_ops, ref as r_bp_ref
from repro.kernels.hash_probe import kernel as r_hp_kernel
from repro.kernels.hash_probe import ops as r_hp_ops, ref as r_hp_ref
from repro.kernels.scan_filter import ops as r_sf_ops, ref as r_sf_ref
from repro.kernels.sorted_search import ops as r_ss_ops, ref as r_ss_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.bloom_probe import kernel as p_bp_kernel
from repro_torch.kernels.bloom_probe import ops as p_bp_ops, ref as p_bp_ref
from repro_torch.kernels.hash_probe import kernel as p_hp_kernel
from repro_torch.kernels.hash_probe import ops as p_hp_ops, ref as p_hp_ref
from repro_torch.kernels.scan_filter import kernel as p_sf_kernel
from repro_torch.kernels.scan_filter import ops as p_sf_ops
from repro_torch.kernels.sorted_search import kernel as p_ss_kernel
from repro_torch.kernels.sorted_search import ops as p_ss_ops


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("n,q", [(512, 256), (1000, 300), (64, 1000),
                                 (4096, 512)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_sorted_search_matches_reference(n, q, dtype, rng):
    """float32 queries include NaNs: the reference op counts keys <= q, so
    a NaN ranks 0.  The reference's own oracle (``jnp.searchsorted``)
    sorts NaN last and disagrees with its op there, so it is held on the
    other queries only."""
    keys = np.sort(rng.integers(0, 1 << 20, n)).astype(dtype)
    queries = rng.integers(-5, 1 << 20, q).astype(dtype)
    if dtype == np.float32:
        queries[rng.integers(0, q, 7)] = np.nan
    got = p_ss_ops.sorted_search(torch.as_tensor(keys),
                                 torch.as_tensor(queries)).numpy()
    want = np.asarray(r_ss_ops.sorted_search(
        jnp.asarray(keys), jnp.asarray(queries), interpret=True))
    oracle = np.asarray(r_ss_ref.sorted_search_ref(jnp.asarray(keys),
                                                   jnp.asarray(queries)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    real = ~np.isnan(queries.astype(np.float64))
    np.testing.assert_array_equal(got[real], oracle[real])
    assert (got[~real] == 0).all()


def test_sorted_search_nan_query_ranks_zero():
    """keys [-1, 0, 1, 2, 3], queries [nan, 0.5]: the reference op says
    [0, 2]; ``torch.searchsorted`` alone would rank the NaN 5."""
    keys = np.asarray([-1, 0, 1, 2, 3], np.float32)
    queries = np.asarray([np.nan, 0.5], np.float32)
    got = p_ss_ops.sorted_search(torch.as_tensor(keys),
                                 torch.as_tensor(queries)).numpy()
    want = np.asarray(r_ss_ops.sorted_search(
        jnp.asarray(keys), jnp.asarray(queries), interpret=True))
    np.testing.assert_array_equal(got, [0, 2])
    np.testing.assert_array_equal(got, want)
    found, vals = p_ss_ops.sorted_get(torch.as_tensor(keys),
                                      torch.arange(5, dtype=torch.int32),
                                      torch.as_tensor(queries))
    assert not found.any() and (vals == 0).all()


def test_sorted_get_matches_reference(rng):
    keys = np.sort(rng.choice(1 << 16, 700, replace=False)).astype(np.int32)
    values = (keys * 3 + 1).astype(np.int32)
    queries = np.concatenate([keys[rng.integers(0, len(keys), 100)],
                              np.asarray([1 << 20, -3], np.int32)])
    f_p, v_p = p_ss_ops.sorted_get(torch.as_tensor(keys),
                                   torch.as_tensor(values),
                                   torch.as_tensor(queries))
    f_r, v_r = r_ss_ops.sorted_get(jnp.asarray(keys), jnp.asarray(values),
                                   jnp.asarray(queries), interpret=True)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    assert f_p[:100].all() and not f_p[100:].any()


@pytest.mark.parametrize("s,cap,n", [(6, 32, 500), (8, 16, 1000),
                                     (10, 8, 2000), (4, 4, 300)])
def test_build_table_matches_reference(s, cap, n, rng):
    """Vectorized build == the reference's insertion loop, including the
    order within a bucket and the entries a full bucket drops."""
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int64)
    keys[-5:] = keys[:5]                    # duplicates keep both entries
    values = rng.integers(1, 1 << 30, n).astype(np.int32)
    tk_p, tv_p = p_hp_ref.build_table(keys, values, s, p_hp_ops.DEFAULT_A,
                                      cap)
    tk_r, tv_r = r_hp_ref.build_table(keys, values, s, r_hp_ops.DEFAULT_A,
                                      cap)
    np.testing.assert_array_equal(tk_p, tk_r)
    np.testing.assert_array_equal(tv_p, tv_r)


@pytest.mark.parametrize("s,cap,n", [(6, 32, 500), (8, 16, 1000),
                                     (10, 8, 2000)])
def test_hash_probe_matches_reference(s, cap, n, rng):
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int64)
    values = rng.integers(1, 1 << 30, n).astype(np.int32)
    tk, tv = p_hp_ref.build_table(keys, values, s, p_hp_ops.DEFAULT_A, cap)
    queries = np.concatenate([keys[: n // 2],
                              rng.integers(1 << 21, 1 << 22, 100),
                              [r_hp_ref.EMPTY_KEY]]).astype(np.int32)
    f_p, v_p = p_hp_ops.hash_probe(torch.as_tensor(tk), torch.as_tensor(tv),
                                   torch.as_tensor(queries), s=s)
    f_r, v_r = r_hp_ops.hash_probe(jnp.asarray(tk), jnp.asarray(tv),
                                   jnp.asarray(queries), s=s,
                                   interpret=True)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    pos_p, val_p = p_hp_ops.hash_probe_pos(torch.as_tensor(tk),
                                           torch.as_tensor(tv),
                                           torch.as_tensor(queries), s=s)
    pos_r, val_r = r_hp_ref.hash_probe_ref(tk, tv, queries,
                                           r_hp_ops.DEFAULT_A, s)
    np.testing.assert_array_equal(pos_p.numpy(), pos_r)
    np.testing.assert_array_equal(val_p.numpy(), val_r)
    assert bool(f_p[-1])          # the empty-slot sentinel quirk is kept


@pytest.mark.parametrize("s", [1, 11, 21, 31])
def test_multiply_shift_matches_reference(s, rng):
    x = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    got = p_hp_kernel.multiply_shift(torch.as_tensor(x), p_hp_ops.DEFAULT_A,
                                     s).numpy()
    want = np.asarray(r_hp_kernel.multiply_shift(
        jnp.asarray(x), r_hp_ops.DEFAULT_A, s)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, p_hp_ref.multiply_shift_np(x, p_hp_ops.DEFAULT_A, s))


def test_kv_store_path_matches_reference():
    """examples/kv_store.py's sorted-array and hash-table stores at its
    N=20,000 and Q=512: both packages find the same Q/2 keys."""
    rng = np.random.default_rng(0)
    n, q = 20_000, 512
    keys = rng.choice(1 << 24, n, replace=False).astype(np.int64)
    values = rng.integers(1, 1 << 30, n).astype(np.int32)
    queries = np.concatenate([keys[: q // 2],
                              rng.integers(1 << 25, 1 << 26, q // 2)]
                             ).astype(np.int32)
    order = np.argsort(keys)
    sk, sv = keys[order].astype(np.int32), values[order]
    reset_launch_counts()
    f_p, v_p = p_ss_ops.sorted_get(torch.as_tensor(sk), torch.as_tensor(sv),
                                   torch.as_tensor(queries))
    f_r, v_r = r_ss_ops.sorted_get(jnp.asarray(sk), jnp.asarray(sv),
                                   jnp.asarray(queries), interpret=True)
    assert int(f_p.sum()) == q // 2
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    np.testing.assert_array_equal(v_p.numpy()[: q // 2], values[: q // 2])

    tk, tv = p_hp_ref.build_table(keys, values, 11, p_hp_ops.DEFAULT_A, 32)
    f_p, v_p = p_hp_ops.hash_probe(torch.as_tensor(tk), torch.as_tensor(tv),
                                   torch.as_tensor(queries), s=11)
    f_r, v_r = r_hp_ops.hash_probe(jnp.asarray(tk), jnp.asarray(tv),
                                   jnp.asarray(queries), s=11,
                                   interpret=True)
    assert int(f_p.sum()) == q // 2
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    # CPU tensors take the plain versions: no kernel was launched
    assert launch_counts().get("sorted_search", 0) == 0
    assert launch_counts().get("hash_probe", 0) == 0


def test_kernel_wrappers_refuse_cpu_and_other_devices():
    keys = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        p_ss_kernel.sorted_search_kernel(keys, keys)
    table = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        p_hp_kernel.hash_probe_kernel(table, table, keys, 1, 1)
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        p_ss_ops.sorted_search(meta, meta)
    with pytest.raises(ValueError):
        p_hp_ops.hash_probe(table.to("meta"), table.to("meta"), meta, s=1)


# ---------------------------------------------------------------------------
# scan filter (K2) and bloom probe (K4): the log+bloom store
# ---------------------------------------------------------------------------
INT32_MAX = 2147483647


def _scan_both(keys, queries, lo, hi):
    got = p_sf_ops.scan_filter(*(torch.as_tensor(a)
                                 for a in (keys, queries, lo, hi)))
    want = r_sf_ops.scan_filter(*(jnp.asarray(a)
                                  for a in (keys, queries, lo, hi)),
                                interpret=True)
    oracle = r_sf_ref.scan_filter_ref(*(jnp.asarray(a)
                                        for a in (keys, queries, lo, hi)))
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
    return got


@pytest.mark.parametrize("n,q", [(512, 256), (1500, 100), (128, 770)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scan_filter_matches_reference(n, q, dtype, rng):
    keys = rng.integers(0, 1 << 16, n).astype(dtype)
    queries = rng.integers(0, 1 << 16, q).astype(dtype)
    queries[: q // 4] = keys[rng.integers(0, n, q // 4)]   # real hits
    pos, cnt = _scan_both(keys, queries, queries - 64, queries + 64)
    assert (pos.numpy() != INT32_MAX).sum() >= q // 4
    assert cnt.numpy().sum() > 0


def test_scan_get_finds_first_duplicate():
    keys = np.asarray([5, 3, 5, 7, 3, 9] * 100, np.int32)
    values = np.arange(len(keys), dtype=np.int32)
    queries = np.asarray([5, 3, 11], np.int32)
    f_p, v_p = p_sf_ops.scan_get(torch.as_tensor(keys),
                                 torch.as_tensor(values),
                                 torch.as_tensor(queries))
    f_r, v_r = r_sf_ops.scan_get(jnp.asarray(keys), jnp.asarray(values),
                                 jnp.asarray(queries), interpret=True)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    assert f_p.tolist() == [True, True, False]
    assert v_p.tolist()[:2] == [0, 1]   # first occurrences


@pytest.mark.parametrize("present", [True, False])
def test_scan_int32_max_query_never_matches_padding(present, rng):
    """The reference pads keys with int32 max and masks those hits; the
    port has no padding.  Either way a query of int32 max finds a real
    key of that value and nothing else."""
    keys = rng.integers(0, 1 << 20, 700).astype(np.int32)   # 700 % 512 != 0
    if present:
        keys[333] = INT32_MAX
    queries = np.asarray([INT32_MAX, keys[5], -1], np.int32)
    lo = np.asarray([INT32_MAX - 1, 0, -5], np.int32)
    hi = np.full(3, INT32_MAX, np.int32)
    pos, cnt = _scan_both(keys, queries, lo, hi)
    assert pos[0] == (333 if present else INT32_MAX)
    assert cnt[0] == 0          # hi is exclusive: int32 max is never counted


@pytest.mark.parametrize("s,k", [(13, 1), (15, 2), (16, 4)])
def test_bloom_probe_matches_reference(s, k, rng):
    keys = rng.choice(1 << 24, 2000, replace=False).astype(np.int64)
    words_r = r_bp_ref.build_filter(keys, r_bp_ops.DEFAULT_COEFFS[:k], s)
    words = p_bp_ref.build_filter(keys, p_bp_ops.DEFAULT_COEFFS[:k], s)
    np.testing.assert_array_equal(words, words_r)
    queries = np.concatenate([keys[:500], rng.integers(1 << 25, 1 << 26,
                                                       500),
                              [-1, -2**31]]).astype(np.int32)
    got = p_bp_ops.bloom_probe(p_bp_ops.filter_words(words),
                               torch.as_tensor(queries), s=s, num_hashes=k)
    want = r_bp_ops.bloom_probe(jnp.asarray(words), jnp.asarray(queries),
                                s=s, num_hashes=k, interpret=True)
    oracle = r_bp_ref.bloom_probe_ref(words, queries,
                                      r_bp_ops.DEFAULT_COEFFS[:k], s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), oracle)
    # the per-hash hits, against the Pallas kernel's own output
    hits = p_bp_ops.bloom_hits(torch.as_tensor(words.view(np.int32)),
                               torch.as_tensor(queries[:256]), s=s,
                               num_hashes=k)
    hits_r = r_bp_kernel.bloom_probe_kernel(
        jnp.asarray(words), jnp.asarray(queries[:256]),
        jnp.asarray(r_bp_ops.DEFAULT_COEFFS[:k]), s=s,
        block_w=min(256, len(words)), interpret=True)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_r))


def test_bloom_no_false_negatives(rng):
    """The defining bloom filter property, through the port's op."""
    keys = rng.choice(1 << 22, 3000, replace=False).astype(np.int64)
    words = p_bp_ref.build_filter(keys, p_bp_ops.DEFAULT_COEFFS[:3], 16)
    member = p_bp_ops.bloom_probe(words, torch.as_tensor(
        keys.astype(np.int32)), s=16, num_hashes=3)
    assert bool(member.all())


def test_log_bloom_store_matches_reference():
    """examples/kv_store.py's third store at its N=20,000 and Q=512: the
    bloom filter (s=18, k=3) skips misses and the log is scanned for the
    rest; both packages pass the same queries and find the same Q/2."""
    rng = np.random.default_rng(0)
    n, q, s = 20_000, 512, 18
    keys = rng.choice(1 << 24, n, replace=False).astype(np.int64)
    values = rng.integers(1, 1 << 30, n).astype(np.int32)
    queries = np.concatenate([keys[: q // 2],
                              rng.integers(1 << 25, 1 << 26, q // 2)]
                             ).astype(np.int32)
    words = p_bp_ref.build_filter(keys, p_bp_ops.DEFAULT_COEFFS[:3], s)
    reset_launch_counts()
    maybe = p_bp_ops.bloom_probe(words, torch.as_tensor(queries), s=s,
                                 num_hashes=3)
    maybe_r = np.asarray(r_bp_ops.bloom_probe(
        jnp.asarray(words), jnp.asarray(queries), s=s, num_hashes=3,
        interpret=True))
    np.testing.assert_array_equal(maybe.numpy(), maybe_r)
    probe = queries[maybe.numpy()]
    f_p, v_p = p_sf_ops.scan_get(torch.as_tensor(keys.astype(np.int32)),
                                 torch.as_tensor(values),
                                 torch.as_tensor(probe))
    f_r, v_r = r_sf_ops.scan_get(jnp.asarray(keys.astype(np.int32)),
                                 jnp.asarray(values), jnp.asarray(probe),
                                 interpret=True)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    assert int(f_p.sum()) == q // 2
    assert bool(maybe[: q // 2].all())          # no false negatives
    # CPU tensors take the plain versions: no kernel was launched
    assert launch_counts().get("bloom_probe", 0) == 0
    assert launch_counts().get("scan_filter", 0) == 0


def test_log_bloom_wrappers_refuse_cpu_and_other_devices():
    keys = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        p_sf_kernel.scan_filter_kernel(keys, keys, keys, keys)
    with pytest.raises(ValueError):
        p_bp_kernel.bloom_probe_kernel(keys, keys,
                                       p_bp_ops.DEFAULT_COEFFS[:2], 8)
    meta = keys.to("meta")
    with pytest.raises(ValueError):
        p_sf_ops.scan_filter(meta, meta, meta, meta)
    with pytest.raises(ValueError):
        p_bp_ops.bloom_probe(meta, meta, s=8)
