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
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.hash_probe import kernel as hp_kernel
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.hash_probe.ops import DEFAULT_A
from repro_torch.kernels.moe_combine import kernel as mc_kernel
from repro_torch.kernels.moe_combine import ref as mc_ref
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
    infinities and both zeros as keys, and NaN queries (rank 0: a NaN
    compares false with every key); keys off 16-byte alignment (the
    scalar window)."""
    info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
    runs = [(-5, 3000), (0, 1), (7, 5000), (8, 4096), (info.max, 33)]
    nans = np.zeros(0, dtype)
    if dtype == np.float32:
        runs = [(-np.inf, 2), (-0.0, 40), (0.0, 41)] + runs + [(np.inf, 3)]
        nans = np.asarray([np.nan, -np.nan, np.nan], dtype)
    keys_np = np.sort(np.concatenate([np.full(c, v, dtype)
                                      for v, c in runs]), kind="stable")
    queries = torch.as_tensor(np.concatenate([
        np.asarray([-6, -5, 6, 7, 8, 9], dtype), nans,
        _extreme_queries(dtype)]), device=cuda)
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


def _assert_one_launch(before, kind, backward=False):
    """K5's forward (or, with ``backward``, its backward) launched once
    since ``before``, on variant ``kind`` (a forward variant, or with
    ``backward`` a backward one), and nothing else of K5."""
    after = launch_counts()
    moved = {n: after[n] - before.get(n, 0) for n in after
             if n.startswith("flash_attention")}
    name = "flash_attention_bwd" if backward else "flash_attention"
    want = {"flash_attention": 0, "flash_attention_bwd": 0}
    want.update({f"flash_attention_{o}": 0
                 for o in fa_kernel.VARIANT_LAUNCHES})
    want.update({f"flash_attention_bwd_{o}": 0
                 for o in fa_kernel.BWD_VARIANT_LAUNCHES})
    want.update({name: 1, f"{name}_{kind}": 1})
    assert {n: moved.get(n, 0) for n in want} == want, moved


@pytest.mark.parametrize("b,h,kh,sq,skv,d", [
    (1, 1, 1, 128, 128, 32), (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 512, 16),
    (2, 4, 4, 200, 300, 24), (1, 2, 2, 384, 128, 128), (1, 12, 2, 1000, 777,
                                                         128),
    (1, 2, 1, 70, 70, 256), (1, 2, 1, 300, 200, 16),
    # the tensor-core variant's edges (bf16 at D 64 / 128 / 160): Sq and
    # Skv not multiples of its 128-row / 64-key tiles, GQA group 6, Sq >
    # Skv causal, one key, one query row
    (2, 6, 1, 333, 129, 64), (2, 6, 1, 333, 129, 128), (1, 6, 1, 65, 1, 64),
    (1, 6, 1, 65, 1, 128), (1, 2, 1, 1, 300, 64), (1, 2, 1, 1, 300, 128),
    (3, 6, 1, 257, 257, 64), (1, 12, 2, 1000, 777, 64),
    (1, 12, 2, 300, 200, 128),
    (2, 6, 1, 333, 129, 160), (1, 6, 1, 65, 1, 160), (1, 2, 1, 1, 300, 160),
    (1, 12, 2, 1000, 777, 160),
    # the families' new shapes, cut short: pixtral's head dim 160 and its
    # GQA (32 heads on 8), seamless's cross-attention (Sq < Skv, run
    # causal and not)
    (2, 8, 2, 200, 200, 160), (1, 32, 8, 300, 300, 160),
    (2, 4, 4, 128, 320, 64),
    # the tf32x3 variant's edges: each head-dim bucket's tile (64 keys up
    # to W 64, 32 up to 128, 16 above; 128 q rows, 64 from W 192), D 96
    # and 192, D 30 (4-byte copies: rows off 16 bytes), one query row and
    # one key at the wide buckets, ragged Skv, causal Sq > Skv, GQA 6
    (1, 4, 1, 200, 150, 96), (1, 2, 1, 150, 200, 192), (1, 6, 1, 1, 300, 96),
    (1, 6, 1, 70, 1, 192), (1, 6, 1, 129, 33, 256), (2, 4, 2, 100, 90, 30),
    (1, 2, 1, 1, 1, 16), (2, 6, 1, 300, 17, 160)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kh, sq, skv, d,
                                              causal, dtype):
    """Against attention_ref in float32 on the same inputs: float32 to
    1e-5; bf16 to the rounding of a float32 result to bf16 (2^-8
    relative) plus 1e-4; each row's lse within 1e-5.  bf16 at D 64 / 128 /
    160 runs the wgmma variant, the rest the tf32x3 one; the counters say
    which ran.  The model's [B, S, H, D] layout, read and written through
    strides, gives the same output bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(sq * skv + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d)))
    before = launch_counts()
    got, lse = fa_kernel.flash_attention_kernel(q, k, v, causal)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    assert got.dtype == dtype
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else
           dict(rtol=2.0 ** -8, atol=1e-4))
    torch.testing.assert_close(got.float(), want, **tol)
    _assert_one_launch(before, fa_kernel.variant(dtype, d))
    # the rows' log-sum-exp, float32 in both variants
    torch.testing.assert_close(
        lse, attention_lse_ref(q.float(), k.float(), v.float(), causal),
        rtol=1e-5, atol=1e-5)
    # the model layout through strides, no copy
    bshd = fa_ops.flash_attention_bshd(q.transpose(1, 2).contiguous(),
                                       k.transpose(1, 2).contiguous(),
                                       v.transpose(1, 2).contiguous(), causal)
    torch.testing.assert_close(bshd.transpose(1, 2), got, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_wgmma_d160_reads_no_column_past_d(cuda, causal):
    """At D 160 the tensor-core variant's third box spans columns 128-191:
    TMA must fill 160-191 with zeros, never read them from memory.  q, k
    and v are [..., :160] views of [B, S, H, 192] tensors whose columns
    160-191 hold NaN; the output is finite and equals the contiguous
    inputs' output bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(160)
    wide = []
    for s, h in ((300, 8), (270, 2), (270, 2)):
        x = torch.randn((2, s, h, 192), generator=gen, device=cuda)
        x[..., 160:] = float("nan")
        wide.append(x.to(torch.bfloat16))
    q, k, v = (x[..., :160].transpose(1, 2) for x in wide)
    before = launch_counts()
    got, _ = fa_kernel.flash_attention_kernel(q, k, v, causal)
    _assert_one_launch(before, "wgmma")
    assert bool(torch.isfinite(got).all())
    dense, _ = fa_kernel.flash_attention_kernel(
        *(x.contiguous() for x in (q, k, v)), causal)
    torch.testing.assert_close(got, dense, rtol=0, atol=0)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-4)


def test_flash_attention_grad_on_the_card(cuda):
    """Forward and backward on K5 (float32: the tf32x3 forward and
    backward): the gradient equals autograd of the plain version within
    1e-5 (3xTF32 products summed in other orders)."""
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


@pytest.mark.parametrize("d", [64, 128, 160])
def test_flash_attention_tf32x3_forward_spills_nothing(cuda, d):
    """The tf32x3 forward at the buckets the float32 paths run (the
    families' D 64, qwen2-1.5b's 128, pixtral's 160): no local memory (no
    spills), at most 255 registers a thread, its shared memory within the
    227 KB a block may have."""
    info = fa_kernel.fwd_tf32x3_info(d)
    assert info["local_bytes"] == 0, info
    assert 0 < info["registers"] <= 255, info
    assert 0 < info["smem_bytes"] <= 232448, info


def _rel_rms(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want) ** 2).mean().sqrt() /
                 (want ** 2).mean().sqrt())


@pytest.mark.parametrize("b,sq,dtype", [(4, 2048, torch.bfloat16),
                                         (1, 512, torch.bfloat16),
                                         (1, 512, torch.float32)])
def test_flash_attention_training_shape_forward_and_backward(cuda, b, sq,
                                                             dtype):
    """qwen2-1.5b's training attention, ``[B, 12/2, S, 128]`` causal in the
    model's [B, S, H, D] layout (the full step's shape first): the forward
    on K5 (``wgmma`` in bf16) within the kernel tests' tolerance of
    attention_ref in float32, one launch; the backward on K5's backward
    kernel, one launch of the same variant, against the float32 pullback
    (autograd of attention_ref on the inputs in float32): float32 within
    1e-5 (see below); bf16, whose kernel rounds P and dS to bf16 once and
    writes bf16 gradients, by a witness: each gradient's rms distance
    from the float32 pullback at most 1.25x SDPA backward's on the same
    inputs."""
    import torch.nn.functional as F
    gen = torch.Generator(device=cuda).manual_seed(sq + b)
    xs = [torch.randn((b, sq, h, 128), generator=gen, device=cuda).to(dtype)
          for h in (12, 2, 2)]
    w = torch.randn((b, sq, 12, 128), generator=gen, device=cuda).to(dtype)
    a = [x.clone().requires_grad_(True) for x in xs]
    before = launch_counts()
    out = fa_ops.flash_attention_bshd(*a, causal=True)
    _assert_one_launch(before, fa_kernel.variant(dtype, 128))
    f32 = [x.float().requires_grad_(True) for x in xs]
    exact = attention_ref(*(x.transpose(1, 2) for x in f32),
                          causal=True).transpose(1, 2)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else
           dict(rtol=2.0 ** -8, atol=1e-4))
    torch.testing.assert_close(out.float(), exact.detach(), **tol)
    before = launch_counts()
    (out * w).sum().backward()
    _assert_one_launch(before, fa_kernel.bwd_variant(dtype, 128),
                       backward=True)
    (exact * w.float()).sum().backward()
    if dtype == torch.float32:
        # an early key's dK or dV sums up to 512 rows x 6 heads of terms
        # that largely cancel (key 0 of [1, 512, 2, 128], about 0.014), and
        # the kernel sums them in another order than autograd's pullback,
        # so float32 rounding alone can move such an element by ~1e-5:
        # each element within 1e-5 of attention_bwd_ref (the same
        # equations on the same out and lse), each gradient within 1e-5
        # relative rms of the pullback
        t = [x.transpose(1, 2) for x in xs]
        want = attention_bwd_ref(*t, out.detach().transpose(1, 2),
                                 attention_lse_ref(*t, causal=True),
                                 w.transpose(1, 2), True)
        for x, y, z in zip(a, f32, want):
            torch.testing.assert_close(x.grad, z.transpose(1, 2), rtol=1e-5,
                                       atol=1e-5)
            assert _rel_rms(x.grad, y.grad) <= 1e-5
        return
    lib = [x.transpose(1, 2).contiguous().requires_grad_(True) for x in xs]
    ref = F.scaled_dot_product_attention(*lib, is_causal=True,
                                         enable_gqa=True)
    (ref * w.transpose(1, 2)).sum().backward()
    for x, y, z in zip(a, f32, lib):
        ours = _rel_rms(x.grad, y.grad)
        sdpa = _rel_rms(z.grad.transpose(1, 2), y.grad)
        assert ours <= 1.25 * sdpa, (ours, sdpa)


def _bwd_float64(q, k, v, out, lse, dout, causal):
    """attention_bwd_ref's equations (the FlashAttention-2 backward from the
    saved out and lse) evaluated in float64: the gradients of the given
    inputs to well below float32's rounding."""
    import math
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    q, k, v, out, lse, dout = (x.double() for x in (q, k, v, out, lse,
                                                    dout))
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    p = torch.exp(q @ kk.transpose(-1, -2) / math.sqrt(d) - lse[..., None])
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None] >=
                torch.arange(skv, device=q.device)[None, :])
        p = torch.where(keep, p, 0.0)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (dout @ vv.transpose(-1, -2) - delta)
    dq = ds @ kk / math.sqrt(d)
    dk = ds.transpose(-1, -2) @ q / math.sqrt(d)
    dv = p.transpose(-1, -2) @ dout
    return (dq, dk.reshape(b, kh, g, skv, d).sum(2),
            dv.reshape(b, kh, g, skv, d).sum(2))


def _assert_float32_gradient(got, ref, exact):
    """A float32 gradient within 1e-5 + 1e-5 |exact| of the float64
    evaluation of attention_bwd_ref's equations (``exact``) at every
    element, and its rms distance from attention_bwd_ref's own (``ref``)
    within 1e-5 + 1e-5 rms(ref), what that limit held element-wise
    implies (the absolute term for gradients that are cancellation noise:
    a row keeping one key has dS = 0 in exact arithmetic).
    attention_bwd_ref sums in float32, so where a gradient sums
    thousands of terms (an early key's dK and dV: 6 heads x up to 2,048
    rows) its own rounding passes that element limit (measured on an
    H100 against this float64 evaluation: 1.24x the limit at (1, 12, 2,
    1000, 777, 128), 1.03x at (2, 12, 2, 2048, 2048, 128); the kernel's
    0.36x and 0.62x) and cannot serve as the element-wise yardstick."""
    torch.testing.assert_close(got.double(), exact.to(got.device),
                               rtol=1e-5, atol=1e-5)
    err = float(((got - ref) ** 2).mean().sqrt())
    assert err <= 1e-5 * float((ref ** 2).mean().sqrt()) + 1e-5, err


#: (B, H, KH, Sq, Skv, D): ragged lengths off every tile size, Sq != Skv
#: both ways (causal with Sq > Skv among them), GQA groups 1, 2, 4 and 6,
#: one key and one query row; and a long GQA case with few KV heads, whose
#: dK/dV pass is split over several blocks a KV tile (dkv_splits > 1 on a
#: card of more than 64 SMs)
BWD_SHAPES = [(1, 2, 1, 200, 200, 64), (2, 4, 2, 333, 129, 64),
              (1, 6, 1, 65, 1, 64), (1, 2, 1, 1, 300, 64),
              (1, 8, 2, 300, 200, 128), (2, 4, 4, 128, 320, 128),
              (1, 12, 2, 1000, 777, 128), (1, 4, 1, 257, 257, 128),
              (2, 8, 2, 200, 200, 160), (1, 32, 8, 300, 300, 160),
              (1, 6, 1, 333, 129, 160), (1, 2, 1, 1, 300, 160),
              (2, 12, 2, 2048, 2048, 128)]


@pytest.mark.parametrize("shape", BWD_SHAPES +
                         [(2, 4, 2, 200, 300, 32), (1, 4, 1, 300, 200, 96)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_kernel_matches_plain(cuda, shape, causal,
                                                       dtype):
    """K5's backward against attention_bwd_ref on the same inputs, out and
    lse (the kernel's forward's) and output gradient: float32 (tf32x3)
    within 1e-5 (+ 1e-5 relative) of its equations in float64, and by
    rms of it (:func:`_assert_float32_gradient`); bf16 at D
    64 / 128 / 160 (wgmma) and at other D (tf32x3) within 1e-2 relative
    rms (+ 1e-5 absolute), the bf16 rounding of P and dS (wgmma) and of
    the gradients (2^-9 relative each).  One backward launch of the
    variant ``bwd_variant`` names, and two calls are bit-equal."""
    b, h, kh, sq, skv, d = shape
    gen = torch.Generator(device=cuda).manual_seed(sq * skv + d + causal)
    q, k, v, g = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                  for s in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d),
                            (b, h, sq, d)))
    out, lse = fa_kernel.flash_attention_kernel(q, k, v, causal)
    before = launch_counts()
    got = fa_kernel.flash_attention_bwd_kernel(q, k, v, out, lse, g, causal)
    _assert_one_launch(before, fa_kernel.bwd_variant(dtype, d),
                       backward=True)
    want = attention_bwd_ref(*(x.float() for x in (q, k, v, out)), lse,
                             g.float(), causal)
    exact = (_bwd_float64(q, k, v, out, lse, g, causal)
             if dtype == torch.float32 else want)
    for x, y, t, like in zip(got, want, exact, (q, k, v)):
        assert x.dtype == dtype and x.shape == like.shape
        if dtype == torch.float32:
            _assert_float32_gradient(x, y, t)
        else:
            # (+ 1e-5 absolute where the gradient is cancellation noise:
            # a row keeping one key has dS = dP - delta = 0 in exact
            # arithmetic, ~1e-7 in both)
            err = float(((x.float() - y) ** 2).mean().sqrt())
            assert bool(torch.isfinite(x).all())
            assert err <= 1e-2 * float((y ** 2).mean().sqrt()) + 1e-5, err
    again = fa_kernel.flash_attention_bwd_kernel(q, k, v, out, lse, g, causal)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_unsplit_dkv_pass(cuda, monkeypatch, shape,
                                                   dtype):
    """The dK/dV pass without its split (dkv_splits forced to 1, as on a
    grid that fills the card: one block a KV tile writes dK and dV itself,
    no partials, no fourth kernel), causal, held to the same limits as
    the test above; one backward launch and two calls bit-equal."""
    b, h, kh, sq, skv, d = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + d)
    q, k, v, g = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                  for s in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d),
                            (b, h, sq, d)))
    out, lse = fa_kernel.flash_attention_kernel(q, k, v, True)
    monkeypatch.setattr(fa_kernel, "dkv_splits", lambda *args: 1)
    before = launch_counts()
    got = fa_kernel.flash_attention_bwd_kernel(q, k, v, out, lse, g, True)
    _assert_one_launch(before, fa_kernel.bwd_variant(dtype, d),
                       backward=True)
    want = attention_bwd_ref(*(x.float() for x in (q, k, v, out)), lse,
                             g.float(), True)
    exact = (_bwd_float64(q, k, v, out, lse, g, True)
             if dtype == torch.float32 else want)
    for x, y, t in zip(got, want, exact):
        if dtype == torch.float32:
            _assert_float32_gradient(x, y, t)
        else:
            err = float(((x.float() - y) ** 2).mean().sqrt())
            assert err <= 1e-2 * float((y ** 2).mean().sqrt()) + 1e-5, err
    again = fa_kernel.flash_attention_bwd_kernel(q, k, v, out, lse, g, True)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 160),
                                     (torch.float32, 64)])
def test_flash_attention_backward_layouts(cuda, dtype, d):
    """The model's [B, S, H, D] layout (read and written through strides)
    gives the contiguous inputs' gradients bit for bit, laid out like the
    inputs; so does a stride-0 output gradient (``out.sum()``'s), which
    the wrapper copies to a contiguous one; each backward is one launch of
    K5's backward and launches nothing else."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    xs = [torch.randn((2, 300, h, d), generator=gen, device=cuda).to(dtype)
          for h in (8, 2, 2)]
    grads = {}
    for layout in ("bshd", "bhsd"):
        a = [x.clone().requires_grad_(True) if layout == "bshd" else
             x.transpose(1, 2).contiguous().requires_grad_(True) for x in xs]
        fn = fa_ops.flash_attention_bshd if layout == "bshd" else \
            fa_ops.flash_attention
        out = fn(*a, causal=True)
        before = launch_counts()
        out.sum().backward()
        _assert_one_launch(before, fa_kernel.bwd_variant(dtype, d),
                           backward=True)
        for x, t in zip(a, xs):
            assert x.grad.stride() == x.stride()
        grads[layout] = [x.grad if layout == "bhsd" else
                         x.grad.transpose(1, 2) for x in a]
        # out.sum()'s gradient is a stride-0 expand; a dense one of ones
        ones = torch.ones(out.shape, device=cuda, dtype=dtype)
        again = torch.autograd.grad(fn(*a, causal=True), a, ones)
        for x, y in zip(again, (t.grad for t in a)):
            assert torch.equal(x, y)
    for x, y in zip(grads["bshd"], grads["bhsd"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [64, 160])
def test_flash_attention_wgmma_rejects_unaligned(cuda, d):
    """TMA reads only 16-byte aligned rows and bases: an input without
    them raises ValueError, launches nothing, and never falls back."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    wide = torch.randn((1, 2, 100, d + 4), generator=gen,
                       device=cuda).to(torch.bfloat16)
    k = torch.randn((1, 1, 100, d), generator=gen,
                    device=cuda).to(torch.bfloat16)
    flat = torch.randn(1 + 2 * 100 * d, generator=gen,
                       device=cuda).to(torch.bfloat16)
    # rows 2 d + 8 bytes apart; a base 2 bytes off
    for q in (wide[..., :d], flat[1:].view(1, 2, 100, d)):
        before = launch_counts()
        with pytest.raises(ValueError, match="TMA"):
            fa_kernel.flash_attention_kernel(q, k, k, True)
        assert launch_counts() == before


# ---------------------------------------------------------------------------
# The MoE combine (kernels/moe_combine)
# ---------------------------------------------------------------------------
#: (T, D, E, k): granite-moe-1b-a400m's 4,096-token batch (16 x 4,096
#: tokens, C 20,480), phi3.5-moe's widths, one decode token; then small
#: edges: D 8 and 24 (rows of 1 and 3 16-byte vectors in bf16), k 1 and
#: 3, k over the 8 loads of a round (k 12)
COMBINE_SHAPES = [(65_536, 1024, 32, 8), (8192, 4096, 16, 2),
                  (1, 1024, 32, 8), (7, 8, 4, 1), (33, 24, 16, 2),
                  (100, 64, 8, 3), (50, 40, 16, 12)]


def _one_rounding(dtype, x):
    """The most one round-to-nearest of ``x`` to ``dtype`` can move it:
    half an ulp, relative above the dtype's normal range (unit roundoff
    eps / 2) and half the subnormals' spacing below it (fp16's 2^-25)."""
    info = torch.finfo(dtype)
    return info.eps / 2 * x.abs() + info.tiny * info.eps / 2


def _combine_inputs(dev, t, d, e, k, dtype, seed, capacity_factor=1.25):
    """The real router's choices for random logits, and expert outputs
    [E, C, D] of ``dtype``."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe

    class Cfg:
        moe = MoEConfig(e, k, capacity_factor)

    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((t, e), generator=gen, device=dev)
    r = dict(zip(moe.ROUTE_KEYS, moe._route(logits, Cfg)))
    c = r["token_ids"].shape[1]
    out = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
    return (out, r["combine_w"], r["gate_idx"], r["token_ids"],
            r["gathered_mask"])


@pytest.mark.parametrize("shape", COMBINE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_moe_combine_kernel_matches_plain(cuda, shape, dtype):
    """Within one rounding of the float32 sum to the output's dtype (the
    kernel's one rounding: half an ulp, or half fp16's subnormal spacing
    near zero), plus float32 slack for its fused
    multiply-adds against the plain version's separate roundings (k ulps of
    the sum of the terms' magnitudes)."""
    t, d, e, k = shape
    if dtype != torch.bfloat16 and t * d > 1 << 25:
        t //= 8                       # the large shapes' other dtypes, cut
    _assert_combine_matches_plain(
        _combine_inputs(cuda, t, d, e, k, dtype, seed=t + d + e + k))


@pytest.mark.parametrize("t, capacity_factor", [(32_768, 0.5),
                                                 (4096, 72 / 10)])
def test_moe_combine_kernel_at_granite_4_h_small_widths(cuda, t,
                                                        capacity_factor):
    """Top-10 of 72 experts at D 4,096 (two rounds of the kernel's 8
    loads a token, k over 8): the 32,768-token prompt of its prefill cell
    with half the assignments' room (drops: random logits route evenly,
    so the cell's factor 1.25 drops none of them here), and 4,096 tokens
    with a capacity that holds every assignment (none; C = T, so [E, C,
    D] is 2.4 GB), within the bound of the test above."""
    args = _combine_inputs(cuda, t, 4096, 72, 10, torch.bfloat16,
                           seed=10, capacity_factor=capacity_factor)
    kept = int(args[4].sum())
    assert (kept < t * 10) == (capacity_factor < 7)
    _assert_combine_matches_plain(args)


def _assert_combine_matches_plain(args):
    out, rest = args[0], args[1:]
    dtype, (t, k), d = out.dtype, rest[1].shape, out.shape[2]
    before = launch_counts().get("moe_combine", 0)
    got = mc_kernel.moe_combine_kernel(*args)
    torch.cuda.synchronize()
    assert launch_counts()["moe_combine"] == before + 1
    assert got.dtype == dtype and got.shape == (t, d)
    want = mc_ref.moe_combine_ref(out.float(), *rest)
    scale = mc_ref.moe_combine_ref(out.float().abs(), rest[0].abs(),
                                   *rest[1:])
    bound = (_one_rounding(dtype, want) +
             2 * k * torch.finfo(torch.float32).eps * scale)
    err = (got.float() - want).abs()
    assert (err <= bound).all(), float((err - bound).max())


def test_moe_combine_kernel_is_bit_repeatable(cuda):
    """No atomics: two calls at granite's 4,096-token batch are
    bit-equal."""
    args = _combine_inputs(cuda, *COMBINE_SHAPES[0], torch.bfloat16, seed=3)
    first = mc_kernel.moe_combine_kernel(*args)
    assert torch.equal(first, mc_kernel.moe_combine_kernel(*args))


def test_moe_combine_kernel_reads_no_padding_row(cuda):
    """Padding slots (gathered_mask 0) poisoned with NaN: the kernel
    never reads them, so the sum stays finite and equal."""
    args = list(_combine_inputs(cuda, 4096, 1024, 32, 8, torch.bfloat16,
                                seed=4, capacity_factor=0.5))
    want = mc_kernel.moe_combine_kernel(*args)
    args[0] = args[0].clone()
    args[0][args[4] == 0] = float("nan")
    got = mc_kernel.moe_combine_kernel(*args)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_moe_ffn_launches_the_combine_only_without_autograd(cuda):
    """A prefill under ``torch.no_grad`` launches the combine once a
    layer; a forward that autograd records keeps the scatter-add (no
    launch) and still has a gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.models import moe
    cfg = get_smoke_config("granite-moe-1b-a400m")
    model = build(cfg)
    params = model.init(0, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 48)), device=cuda)
    reset_launch_counts()
    with torch.no_grad():
        model.prefill(params, tokens, 64)
    torch.cuda.synchronize()
    assert launch_counts()["moe_combine"] == cfg.n_layers
    layer = {n: p.detach().clone().requires_grad_(True)
             for n, p in params["layers"][0]["moe"].items()}
    x = torch.randn((2, 48, cfg.d_model), device=cuda,
                    dtype=cfg.cdtype())
    reset_launch_counts()
    y, aux = moe.moe_ffn(layer, x, cfg)
    (y.float().sum() + aux).backward()
    torch.cuda.synchronize()
    assert launch_counts()["moe_combine"] == 0
    assert layer["w_down"].grad is not None
    with torch.no_grad():
        moe.moe_ffn(layer, x, cfg)
    assert launch_counts()["moe_combine"] == 1


def test_moe_combine_kernel_rejects_what_it_does_not_take(cuda):
    """Shapes, dtypes and layouts it does not handle raise, and nothing
    launches (no fallback)."""
    out, w, gi, ti, gm = _combine_inputs(cuda, 64, 64, 8, 2,
                                         torch.bfloat16, seed=5)
    off = torch.empty(out.numel() + 1, dtype=out.dtype, device=cuda)
    off = off[1:].view(out.shape)                # 2 bytes off 16
    off.copy_(out)
    bad = [(out[..., :12].contiguous(), w, gi, ti, gm),      # D 12
           (out.to(torch.int32), w, gi, ti, gm),             # dtype
           (out.transpose(0, 1), w, gi, ti, gm),             # layout
           (off, w, gi, ti, gm),                             # alignment
           (out, w.double(), gi, ti, gm),
           (out, w, gi.to(torch.int32), ti, gm),
           (out, w[:-1], gi, ti, gm),                        # T
           (out[:-1].contiguous(), w, gi, ti, gm[:-1]),      # E
           (out, w, gi, ti, gm.cpu())]                       # device
    before = launch_counts().get("moe_combine", 0)
    for args in bad:
        with pytest.raises(ValueError):
            mc_kernel.moe_combine_kernel(*args)
    assert launch_counts().get("moe_combine", 0) == before


# ---------------------------------------------------------------------------
# The model families on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-1.2b",
                                  "xlstm-350m", "seamless-m4t-large-v2",
                                  "pixtral-12b"])
def test_family_forward_on_the_card_matches_cpu(cuda, arch):
    """Each family's smoke config in float32 compute with flash
    attention: the forward on the card (K5) against the same weights on
    the CPU (K5's plain version), to the LM tolerance of
    tests/test_torch_lm.py (1e-4)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.models.convert import tree_to
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              attn_impl="flash")
    model = build(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    n_embeds = {"audio": 24, "vlm": cfg.n_patches}.get(cfg.family, 0)
    embeds = (rng.standard_normal((2, n_embeds, cfg.d_model)).astype(
        np.float32) if n_embeds else None)

    def run(dev, tree):
        emb = None if embeds is None else torch.as_tensor(embeds, device=dev)
        return model.forward(tree, torch.as_tensor(tokens, device=dev),
                             embeds=emb)[0]

    want = run("cpu", params)
    reset_launch_counts()
    got = run(cuda, tree_to(params, cuda))
    torch.cuda.synchronize()
    from repro_torch.models.hybrid import n_shared_applications
    attention = {"moe": cfg.n_layers, "vlm": cfg.n_layers,
                 "audio": cfg.n_encoder_layers + 2 * cfg.n_layers,
                 "hybrid": n_shared_applications(cfg), "ssm": 0}
    assert launch_counts().get("flash_attention", 0) == \
        attention[cfg.family]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The search slice on the card: fits and a population search
# ---------------------------------------------------------------------------
#: fitted predictions, CUDA against CPU, as a share of max |y|: the
#: tolerance tests/test_torch_fit.py states and justifies for two
#: float32 Adam loops that round differently
FIT_ATOL = 5e-3


@pytest.mark.parametrize("kind", ["linear", "log_linear", "log_loglog",
                                  "nlogn", "sigmoids"])
def test_fit_on_cuda_matches_cpu(cuda, kind):
    from repro_torch.core import models
    rng = np.random.default_rng(17)
    x = np.logspace(2, 8, 40)
    lx = np.log(x + 1.0)
    if kind == "sigmoids":
        y = 1e-9 + 3e-8 / (1 + np.exp(-6.0 * (lx - 9.0)))
    else:
        y = 2e-9 * x + 4e-8 * lx + 1e-7
    y = y * (1 + 0.02 * rng.standard_normal(len(x)))
    on_card = models.fit(kind, x, y, device=cuda)
    on_cpu = models.fit(kind, x, y, device="cpu")
    assert on_card.kind == on_cpu.kind and on_card.x_range == on_cpu.x_range
    for v in on_card.params.values():
        assert isinstance(v, np.ndarray) and v.dtype == np.float32
    got, want = on_card.predict(x, "cpu"), on_cpu.predict(x, "cpu")
    assert np.max(np.abs(got - want)) <= FIT_ATOL * np.max(np.abs(y))


def test_population_search_on_cuda_matches_cpu(cuda):
    """The same seed and budget choose the CPU run's design on the card,
    every generation scored by K0."""
    from repro_torch.core import search
    wl = Workload(n_entries=1_000_000, n_queries=100)
    mix = {"get": 80.0, "update": 20.0}
    kw = dict(population=16, generations=200, refine_top=2, refine_steps=2,
              seed=10, seeds=[el.spec_btree(), el.spec_trie(),
                              el.spec_csb_tree()])
    reset_launch_counts()
    got = search.population_search(wl, hardware.hw3(), mix,
                                   budget=search.SearchBudget(256), **kw)
    k0 = launch_counts().get("bank_score", 0)
    with runtime.use_device("cpu"):
        want = search.population_search(wl, hardware.hw3(), mix,
                                        budget=search.SearchBudget(256),
                                        **kw)
    assert got["design"].describe() == want["design"].describe()
    assert got["designs_costed"] == want["designs_costed"] <= 256
    assert got["generations"] == want["generations"]
    assert abs(got["cost_s"] - want["cost_s"]) <= 1e-6 * want["cost_s"]
    assert k0 >= 1


# ---------------------------------------------------------------------------
# The serving tier's scoring slots on the card
# ---------------------------------------------------------------------------
def _serving_grid():
    specs = [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list(),
             el.spec_btree(fanout=40), el.spec_trie()] * 30
    n_points = 7
    sweep = pack_sweep(specs, [Workload(n_entries=500_000)] * n_points,
                       [{"get": 10.0 + i, "update": 5.0}
                        for i in range(n_points)])
    packed = pack_frontier(specs, Workload(n_entries=800_000),
                           {"get": 60.0, "update": 40.0})
    return sweep, packed


def test_pool_parts_on_two_slots_of_one_card_equal_the_flat_call(
        cuda, monkeypatch):
    """Two slots of cuda:0, each on its own stream, split a sweep and a
    frontier into two K0 launches; the merged totals equal the flat
    call's bit for bit, and so does ``score(shard=True)`` split over two
    devices that are both cuda:0."""
    from repro_torch.serving import ScoringShardPool
    hw = hardware.hw1()
    sweep, packed = _serving_grid()
    flat_grid = sweep.score(hw, shard=False)
    flat_totals = packed.score(hw, shard=False)
    pool = ScoringShardPool(devices=["cuda:0", "cuda:0"],
                            min_cells_per_shard=1)
    try:
        for _ in range(3):
            reset_launch_counts()
            grid, used = pool.score_sweep(sweep, hw)
            assert used == 2 and launch_counts()["bank_score"] == 2
            np.testing.assert_array_equal(grid, flat_grid)
            totals, used = pool.score_frontier(packed, hw)
            assert used == 2
            np.testing.assert_array_equal(totals, flat_totals)
    finally:
        pool.close()
    monkeypatch.setattr(devicecost, "shard_devices",
                        lambda home=None: (torch.device("cuda", 0),) * 2)
    reset_launch_counts()
    np.testing.assert_array_equal(sweep.score(hw, shard=True), flat_grid)
    np.testing.assert_array_equal(packed.score(hw, shard=True),
                                  flat_totals)
    assert launch_counts()["bank_score"] == 4


def test_layout_built_on_one_stream_scores_on_another(cuda):
    """50 times: a fresh layout and fresh banks are built on one stream
    while that stream is held by a device-side sleep, then scored at once
    on another stream — the same totals as the default stream's."""
    import dataclasses
    hw = hardware.hw3()
    sweep, _ = _serving_grid()
    want = sweep.score(hw, shard=False)
    dev = devicecost.resolve(cuda)
    first, second = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    for i in range(50):
        fresh = dataclasses.replace(sweep)          # no memoized layout
        hw_fresh = dataclasses.replace(hw, name=f"HW3-{i}",
                                       models=dict(hw.models))
        with torch.cuda.stream(first):
            torch.cuda._sleep(2_000_000)
            layout = fresh._sweep_arrays(dev)
            devicecost.device_table(hw_fresh, dev)
        with torch.cuda.stream(second):
            got = devicecost.score_sweep(layout, hw_fresh, shard=False)
        np.testing.assert_array_equal(got, want)
    torch.cuda.synchronize()


def test_banks_built_once_per_device(cuda, monkeypatch):
    """A profile's banks are fitted into one table once; each other
    device gets one replica, however many slots and scores use it."""
    from repro_torch.serving import ScoringShardPool
    hw = hardware.hw2()
    sweep, packed = _serving_grid()
    builds = []
    build = devicecost.build_table
    monkeypatch.setattr(devicecost, "build_table",
                        lambda *a, **k: builds.append(1) or build(*a, **k))
    devicecost.invalidate_table(hw)
    pool = ScoringShardPool(devices=["cuda:0", "cuda:0", "cpu"],
                            min_cells_per_shard=1)
    try:
        for _ in range(4):
            assert pool.score_sweep(sweep, hw)[1] == 3
            assert pool.score_frontier(packed, hw)[1] == 3
            packed.score(hw)
    finally:
        pool.close()
    assert builds == [1]
    table = hw._device_table
    replicas = [k for k in devicecost._BANK_REPLICAS.keys()
                if k[0] == id(table)]
    assert len(replicas) == 1
    devicecost.invalidate_table(hw)
    assert not [k for k in devicecost._BANK_REPLICAS.keys()
                if k[0] == id(table)]
