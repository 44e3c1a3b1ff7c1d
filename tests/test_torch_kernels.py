"""Port vs reference: the sorted-array and hash-table store ops on the
CPU (the kernels' plain versions), against the JAX ops run in Pallas
interpret mode and against the reference oracles, on the parameter grids
of tests/test_kernels.py.  Every result must be exactly equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.hash_probe import kernel as r_hp_kernel
from repro.kernels.hash_probe import ops as r_hp_ops, ref as r_hp_ref
from repro.kernels.sorted_search import ops as r_ss_ops, ref as r_ss_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.hash_probe import kernel as p_hp_kernel
from repro_torch.kernels.hash_probe import ops as p_hp_ops, ref as p_hp_ref
from repro_torch.kernels.sorted_search import kernel as p_ss_kernel
from repro_torch.kernels.sorted_search import ops as p_ss_ops


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("n,q", [(512, 256), (1000, 300), (64, 1000),
                                 (4096, 512)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_sorted_search_matches_reference(n, q, dtype, rng):
    keys = np.sort(rng.integers(0, 1 << 20, n)).astype(dtype)
    queries = rng.integers(-5, 1 << 20, q).astype(dtype)
    got = p_ss_ops.sorted_search(torch.as_tensor(keys),
                                 torch.as_tensor(queries)).numpy()
    want = np.asarray(r_ss_ops.sorted_search(
        jnp.asarray(keys), jnp.asarray(queries), interpret=True))
    oracle = np.asarray(r_ss_ref.sorted_search_ref(jnp.asarray(keys),
                                                   jnp.asarray(queries)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


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
