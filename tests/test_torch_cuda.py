"""The port's hand-written kernels against their plain PyTorch versions,
on the GPU.  Every test here needs a CUDA device (plus nvcc for K1-K5 and
Triton for K0) and skips, with that reason, where there is none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.core import devicecost, elements as el, hardware
from repro_torch.core.batchcost import pack_frontier, pack_sweep
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.models import FittedModel
from repro_torch.core.synthesis import Workload
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.bloom_probe import kernel as bp_kernel
from repro_torch.kernels.bloom_probe import ops as bp_ops
from repro_torch.kernels.bloom_probe import ref as bp_ref
from repro_torch.kernels.bloom_probe.ops import DEFAULT_COEFFS
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.hash_probe import kernel as hp_kernel
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.hash_probe.ops import DEFAULT_A
from repro_torch.kernels.scan_filter import kernel as sf_kernel
from repro_torch.kernels.scan_filter import ref as sf_ref
from repro_torch.kernels.sorted_search import kernel as ss_kernel
from repro_torch.kernels.sorted_search import ref as ss_ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    with runtime.use_device("cuda") as dev:
        yield dev


def _extreme_queries(dtype) -> np.ndarray:
    """The dtype's extremes (and, for float32, the infinities and both
    zeros)."""
    info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
    extremes = [info.min, info.max, 0, -1]
    if dtype == np.float32:
        extremes += [-np.inf, np.inf, -0.0, 0.0]
    return np.asarray(extremes, dtype)


def _assert_k1_matches_plain(keys, queries, values):
    before = launch_counts().get("sorted_search", 0)
    got = ss_kernel.sorted_search_kernel(keys, queries)
    torch.testing.assert_close(got, ss_ref.sorted_search_ref(keys, queries),
                               rtol=0, atol=0)
    f1, v1 = ss_kernel.sorted_get_kernel(keys, values, queries)
    f2, v2 = ss_ref.sorted_get_ref(keys, values, queries)
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)
    assert launch_counts()["sorted_search"] == before + 2


# (n, q, key range): N around K1's shared tree (2^15 keys of 4 bytes,
# 2^14 of int64), tiny N, small key ranges (long runs of duplicates), and
# 2^22 keys; 2^20 queries are more tiles than an H100 has SMs for every
# dtype, so blocks of the persistent grid walk several tiles
@pytest.mark.parametrize("n,q,hi", [
    (512, 256, 1 << 20), (1000, 300, 1 << 20), (64, 1000, 1 << 20),
    (1, 7, 1 << 20), (1_000_003, 4099, 1 << 20),
    (2, 9, 4), (31, 70, 8), (32, 70, 8), (33, 70, 8),
    (4095, 5000, 1 << 20), (4096, 5000, 1 << 20), (4097, 5000, 1 << 20),
    (16383, 5000, 1 << 20), (16384, 5000, 1 << 20), (16385, 5000, 1 << 20),
    (32767, 5000, 1 << 20), (32768, 5000, 1 << 20), (32769, 5000, 1 << 20),
    (65_537, 3000, 300), (300_000, 5000, 40), (1 << 22, 1 << 18, 1 << 26),
    (1 << 22, 1 << 20, 1 << 26)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_sorted_search_kernel_matches_plain(cuda, n, q, hi, dtype):
    rng = np.random.default_rng(n + q)
    keys = torch.as_tensor(np.sort(rng.integers(0, hi, n)).astype(dtype),
                           device=cuda)
    queries = torch.as_tensor(np.concatenate([
        rng.integers(-5, hi + 5, q).astype(dtype),
        _extreme_queries(dtype)]), device=cuda)
    values = torch.arange(n, device=cuda, dtype=torch.int64) * 3 + 1
    _assert_k1_matches_plain(keys, queries, values)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_sorted_search_kernel_edge_keys(cuda, dtype):
    """Keys in long runs ending at the dtype's maximum; for float32 the
    infinities and both zeros as keys; keys off 16-byte alignment (the
    scalar window)."""
    info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
    runs = [(-5, 3000), (0, 1), (7, 5000), (8, 4096), (info.max, 33)]
    if dtype == np.float32:
        runs = [(-np.inf, 2), (-0.0, 40), (0.0, 41)] + runs + [(np.inf, 3)]
    keys_np = np.sort(np.concatenate([np.full(c, v, dtype)
                                      for v, c in runs]), kind="stable")
    queries = torch.as_tensor(np.concatenate([
        np.asarray([-6, -5, 6, 7, 8, 9], dtype), _extreme_queries(dtype)]),
        device=cuda)
    for n in (len(keys_np), 33, 32, 31, 2, 1):
        keys = torch.as_tensor(keys_np[-n:], device=cuda)
        values = torch.arange(n, device=cuda, dtype=torch.int32)
        _assert_k1_matches_plain(keys, queries, values)
    buf = torch.as_tensor(keys_np, device=cuda)
    assert buf[1:].data_ptr() % 16 != 0
    _assert_k1_matches_plain(buf[1:], queries,
                             torch.arange(len(keys_np) - 1, device=cuda))


@pytest.mark.parametrize("s,cap,n,q", [(6, 32, 500, 301), (8, 16, 1000, 64),
                                       (10, 8, 2000, 4097),
                                       (7, 40, 3000, 1001), (1, 3, 5, 9),
                                       # rows without 16-byte alignment,
                                       # a row longer than 32 slots, two
                                       # buckets, a full 2^16 + 5 queries
                                       (5, 33, 700, 333), (1, 32, 40, 45),
                                       (12, 32, 60000, 65541)])
def test_hash_probe_kernel_matches_plain(cuda, s, cap, n, q):
    rng = np.random.default_rng(s * cap)
    keys = rng.choice(1 << 20, n, replace=False)
    tk, tv = hp_ref.build_table(keys, keys * 7 + 1, s, DEFAULT_A, cap)
    queries = np.concatenate([keys[: q // 2],
                              rng.integers(1 << 21, 1 << 22, q - q // 2)])
    queries[-1] = hp_ref.EMPTY_KEY      # matches an empty slot, as upstream
    args = [torch.as_tensor(a, device=cuda)
            for a in (tk, tv, queries.astype(np.int32))]
    before = launch_counts().get("hash_probe", 0)
    p1, v1 = hp_kernel.hash_probe_kernel(*args, DEFAULT_A, s)
    p2, v2 = hp_ref.hash_probe_ref(*args, DEFAULT_A, s)
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)
    assert launch_counts()["hash_probe"] == before + 1


def test_hash_probe_kernel_unaligned_table(cuda):
    """A table 4 bytes off 16-byte alignment (cap a multiple of 4) takes
    the kernel's scalar loads, with the same answers."""
    rng = np.random.default_rng(17)
    s, cap = 7, 32
    keys = rng.choice(1 << 20, 3000, replace=False)
    tk, tv = hp_ref.build_table(keys, keys * 5 + 2, s, DEFAULT_A, cap)
    buf = torch.zeros(tk.size + 1, dtype=torch.int32, device=cuda)
    buf[1:] = torch.as_tensor(tk.ravel(), device=cuda)
    t_k = buf[1:].view(tk.shape)
    assert t_k.data_ptr() % 16 == 4 and t_k.is_contiguous()
    t_v = torch.as_tensor(tv, device=cuda)
    queries = np.concatenate([keys[:500], rng.integers(1 << 21, 1 << 22,
                                                       501)])
    queries[0] = hp_ref.EMPTY_KEY
    qq = torch.as_tensor(queries.astype(np.int32), device=cuda)
    p1, v1 = hp_kernel.hash_probe_kernel(t_k, t_v, qq, DEFAULT_A, s)
    p2, v2 = hp_ref.hash_probe_ref(t_k, t_v, qq, DEFAULT_A, s)
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)


def _knn_hw():
    base = hardware.hw1()
    xs = np.logspace(1, 6, 12).astype(np.float32)
    ys = (2e-9 * xs * np.log(xs) + 1e-8).astype(np.float32)
    models = dict(base.models)
    models["random_memory_access"] = FittedModel(
        "knn", {"x": xs, "y": ys}, (float(xs.min()), float(xs.max())))
    return HardwareProfile("HW1+knn", models)


def _ragged_grid(rng, n_points):
    """Designs of 1-6 tiles and longer than K0's record block (9 and 17
    tiles), one empty design, ids over the first 14 models."""
    n_tiles = [1, 2, 3, 4, 5, 6, 0, 9, 17, 3]
    r = sum(n_tiles) * devicecost.TILE
    ids = rng.integers(0, 14, r).astype(np.int32)
    sizes = np.exp(rng.uniform(0, 20, (n_points, r))).astype(np.float32)
    weights = rng.uniform(0, 3, (n_points, r)).astype(np.float32)
    cuts = np.concatenate([[0], np.cumsum(n_tiles)]).astype(np.int32)
    return ids, sizes, weights, cuts


@pytest.mark.parametrize("profile", ["hw1", "knn"])
@pytest.mark.parametrize("n_points", [1, 5, 64, 67])
@pytest.mark.parametrize("layout", ["packed", "ragged"])
def test_bank_score_kernel_matches_plain(cuda, profile, n_points, layout):
    hw = hardware.hw1() if profile == "hw1" else _knn_hw()
    table = devicecost.device_table(hw, cuda)
    if layout == "packed":
        specs = [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list(),
                 el.spec_btree(fanout=40)] * 7
        sweep = pack_sweep(specs, [Workload(n_entries=500_000)] * n_points,
                           [{"get": 10.0 + i, "update": 5.0}
                            for i in range(n_points)])
        args = sweep._sweep_arrays(torch.device(cuda)).arrays
    else:
        args = [torch.as_tensor(a, device=cuda) for a in
                _ragged_grid(np.random.default_rng(n_points), n_points)]
    reset_launch_counts()
    got = devicecost.bank_score(table.banks, *args, table.has_knn)
    assert launch_counts()["bank_score"] == 1
    want = devicecost.bank_score_plain(table.banks, *args, table.has_knn)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("profile", ["hw1", "knn"])
@pytest.mark.parametrize("n_points", [1, 64])
def test_one_k0_launch_per_sweep(cuda, profile, n_points, monkeypatch):
    """A rectangular sweep scores in one K0 launch from its resident
    layout; a repeat score copies nothing to the card."""
    hw = hardware.hw1() if profile == "hw1" else _knn_hw()
    specs = [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list(),
             el.spec_btree(fanout=40)] * 40
    sweep = pack_sweep(specs, [Workload(n_entries=500_000)] * n_points,
                       [{"get": 10.0 + i, "update": 5.0}
                        for i in range(n_points)])
    reset_launch_counts()
    fused = sweep.score(hw)
    assert launch_counts()["bank_score"] == 1
    copies = []
    monkeypatch.setattr(devicecost, "_to_device",
                        lambda *a: copies.append(a))
    np.testing.assert_array_equal(sweep.score(hw), fused)
    assert copies == [] and launch_counts()["bank_score"] == 2
    grouped = sweep.score(hw, engine="grouped")
    np.testing.assert_allclose(fused, grouped, rtol=1e-6)


def test_fused_engine_on_the_card_matches_grouped(cuda):
    specs = [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list()] * 9
    packed = pack_frontier(specs, Workload(n_entries=500_000),
                           {"get": 10.0, "update": 5.0})
    reset_launch_counts()
    fused = packed.score(hardware.hw2())
    assert launch_counts()["bank_score"] >= 1
    grouped = packed.score(hardware.hw2(), engine="grouped")
    np.testing.assert_allclose(fused, grouped, rtol=1e-6)
    before = devicecost.specialisation_count()
    packed.score(hardware.hw3())
    assert devicecost.specialisation_count() == before


@pytest.mark.parametrize("n,q", [(512, 256), (1500, 100), (128, 770),
                                 (1, 1), (300_001, 4097)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scan_filter_kernel_matches_plain(cuda, n, q, dtype):
    rng = np.random.default_rng(n + q)
    keys = rng.integers(0, 1 << 16, n).astype(dtype)
    queries = rng.integers(0, 1 << 16, q).astype(dtype)
    queries[: q // 2] = keys[rng.integers(0, n, q // 2)]
    if dtype == np.int32:
        keys[-1] = queries[-1] = 2147483647        # a real int32-max key
    args = [torch.as_tensor(a, device=cuda)
            for a in (keys, queries, queries - 64, queries + 64)]
    before = launch_counts().get("scan_filter", 0)
    p1, c1 = sf_kernel.scan_filter_kernel(*args)
    p2, c2 = sf_ref.scan_filter_ref(*args)
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    assert launch_counts()["scan_filter"] == before + 1


@pytest.mark.parametrize("s,k,q", [(13, 1, 1000), (16, 4, 4097),
                                   (24, 3, 65536), (5, 2, 7)])
def test_bloom_probe_kernel_matches_plain(cuda, s, k, q):
    rng = np.random.default_rng(s * k)
    keys = rng.choice(1 << 24, 2000, replace=False)
    words = bp_ref.build_filter(keys, DEFAULT_COEFFS[:k], s)
    queries = np.concatenate([keys[: q // 2], rng.integers(
        -2**31, 2**31, q - q // 2)]).astype(np.int32)[:q]
    w = torch.as_tensor(words.view(np.int32), device=cuda)
    qq = torch.as_tensor(queries, device=cuda)
    before = launch_counts().get("bloom_probe", 0)
    got = bp_kernel.bloom_probe_kernel(w, qq, DEFAULT_COEFFS[:k], s)
    want = bp_ref.bloom_hits_ref(w, qq, DEFAULT_COEFFS[:k], s)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert launch_counts()["bloom_probe"] == before + 1


@pytest.mark.parametrize("s,k,q", [(13, 1, 1000), (16, 4, 4097),
                                   (24, 3, 65536), (5, 2, 7)])
def test_bloom_probe_op_is_one_mask_launch(cuda, s, k, q):
    """ops.bloom_probe on the card: the AND of the plain hits, in one
    launch of K4's mask variant and no other."""
    rng = np.random.default_rng(s + k)
    keys = rng.choice(1 << 24, 2000, replace=False)
    words = bp_ref.build_filter(keys, DEFAULT_COEFFS[:k], s)
    queries = np.concatenate([keys[: q // 2], rng.integers(
        -2**31, 2**31, q - q // 2)]).astype(np.int32)[:q]
    w = torch.as_tensor(words.view(np.int32), device=cuda)
    qq = torch.as_tensor(queries, device=cuda)
    before = launch_counts()
    got = bp_ops.bloom_probe(w, qq, s=s, num_hashes=k)
    after = launch_counts()
    want = (bp_ref.bloom_hits_ref(w, qq, DEFAULT_COEFFS[:k], s) == 1).all(1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    moved = {n: after[n] - before.get(n, 0) for n in after
             if after[n] != before.get(n, 0)}
    assert moved == {"bloom_probe_mask": 1}, moved


def _assert_one_launch(before, kind):
    """K5 launched once since ``before``, on variant ``kind``."""
    after = launch_counts()
    moved = {n: after[n] - before.get(n, 0) for n in after
             if n.startswith("flash_attention")}
    want = {"flash_attention": 1}
    want.update({f"flash_attention_{o}": int(o == kind)
                 for o in fa_kernel.VARIANT_LAUNCHES})
    assert moved == want, moved


@pytest.mark.parametrize("b,h,kh,sq,skv,d", [
    (1, 1, 1, 128, 128, 32), (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 512, 16),
    (2, 4, 4, 200, 300, 24), (1, 2, 2, 384, 128, 128), (1, 12, 2, 1000, 777,
                                                         128),
    (1, 2, 1, 70, 70, 256), (1, 2, 1, 300, 200, 16),
    # the tensor-core variant's edges (bf16 at D 64 / 128): Sq and Skv
    # not multiples of its 128-row / 64-key tiles, GQA group 6, Sq > Skv
    # causal, one key, one query row
    (2, 6, 1, 333, 129, 64), (2, 6, 1, 333, 129, 128), (1, 6, 1, 65, 1, 64),
    (1, 6, 1, 65, 1, 128), (1, 2, 1, 1, 300, 64), (1, 2, 1, 1, 300, 128),
    (3, 6, 1, 257, 257, 64), (1, 12, 2, 1000, 777, 64),
    (1, 12, 2, 300, 200, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kh, sq, skv, d,
                                              causal, dtype):
    """Against attention_ref in float32 on the same inputs: float32 to
    1e-5; bf16 to the rounding of a float32 result to bf16 (2^-8
    relative) plus 1e-4.  bf16 at D 64 / 128 runs the tensor-core
    variant, the rest the SIMT one; the counters say which ran."""
    gen = torch.Generator(device=cuda).manual_seed(sq * skv + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d)))
    before = launch_counts()
    got = fa_kernel.flash_attention_kernel(q, k, v, causal)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    assert got.dtype == dtype
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else
           dict(rtol=2.0 ** -8, atol=1e-4))
    torch.testing.assert_close(got.float(), want, **tol)
    _assert_one_launch(before, fa_kernel.variant(dtype, d))
    # the model layout through strides, no copy
    bshd = fa_ops.flash_attention_bshd(q.transpose(1, 2).contiguous(),
                                       k.transpose(1, 2).contiguous(),
                                       v.transpose(1, 2).contiguous(), causal)
    torch.testing.assert_close(bshd.transpose(1, 2), got, rtol=0, atol=0)


def test_flash_attention_grad_on_the_card(cuda):
    """Forward on K5, backward through attention_ref: the gradient equals
    autograd of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shapes = ((2, 4, 100, 32), (2, 2, 100, 32), (2, 2, 100, 32))
    xs = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    w = torch.randn(shapes[0], generator=gen, device=cuda)
    a = [x.clone().requires_grad_(True) for x in xs]
    (fa_ops.flash_attention(*a, True) * w).sum().backward()
    b_ = [x.clone().requires_grad_(True) for x in xs]
    (attention_ref(*b_, causal=True) * w).sum().backward()
    for x, y in zip(a, b_):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)


def test_flash_attention_wgmma_rejects_unaligned(cuda):
    """TMA reads only 16-byte aligned rows and bases: an input without
    them raises ValueError, launches nothing, and never falls back."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    wide = torch.randn((1, 2, 100, 68), generator=gen,
                       device=cuda).to(torch.bfloat16)
    k = torch.randn((1, 1, 100, 64), generator=gen,
                    device=cuda).to(torch.bfloat16)
    flat = torch.randn(1 + 2 * 100 * 64, generator=gen,
                       device=cuda).to(torch.bfloat16)
    # rows 136 bytes apart; a base 2 bytes off
    for q in (wide[..., :64], flat[1:].view(1, 2, 100, 64)):
        before = launch_counts()
        with pytest.raises(ValueError, match="TMA"):
            fa_kernel.flash_attention_kernel(q, k, k, True)
        assert launch_counts() == before
