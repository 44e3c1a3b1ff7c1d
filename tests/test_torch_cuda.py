"""The port's hand-written kernels against their plain PyTorch versions,
on the GPU.  Every test here needs a CUDA device (plus nvcc for K1/K3 and
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
from repro_torch.kernels.hash_probe import kernel as hp_kernel
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.hash_probe.ops import DEFAULT_A
from repro_torch.kernels.sorted_search import kernel as ss_kernel
from repro_torch.kernels.sorted_search import ref as ss_ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    with runtime.use_device("cuda") as dev:
        yield dev


@pytest.mark.parametrize("n,q", [(512, 256), (1000, 300), (64, 1000),
                                 (1, 7), (1_000_003, 4099)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_sorted_search_kernel_matches_plain(cuda, n, q, dtype):
    rng = np.random.default_rng(n + q)
    keys = torch.as_tensor(np.sort(rng.integers(0, 1 << 20, n))
                           .astype(dtype), device=cuda)
    queries = torch.as_tensor(rng.integers(-5, (1 << 20) + 5, q)
                              .astype(dtype), device=cuda)
    values = torch.arange(n, device=cuda, dtype=torch.int64) * 3 + 1
    before = launch_counts().get("sorted_search", 0)
    got = ss_kernel.sorted_search_kernel(keys, queries)
    torch.testing.assert_close(got, ss_ref.sorted_search_ref(keys, queries),
                               rtol=0, atol=0)
    f1, v1 = ss_kernel.sorted_get_kernel(keys, values, queries)
    f2, v2 = ss_ref.sorted_get_ref(keys, values, queries)
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)
    assert launch_counts()["sorted_search"] == before + 2


@pytest.mark.parametrize("s,cap,n,q", [(6, 32, 500, 301), (8, 16, 1000, 64),
                                       (10, 8, 2000, 4097),
                                       (7, 40, 3000, 1001), (1, 3, 5, 9)])
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


def _knn_hw():
    base = hardware.hw1()
    xs = np.logspace(1, 6, 12).astype(np.float32)
    ys = (2e-9 * xs * np.log(xs) + 1e-8).astype(np.float32)
    models = dict(base.models)
    models["random_memory_access"] = FittedModel(
        "knn", {"x": xs, "y": ys}, (float(xs.min()), float(xs.max())))
    return HardwareProfile("HW1+knn", models)


@pytest.mark.parametrize("profile", ["hw1", "knn"])
@pytest.mark.parametrize("n_points", [1, 5])
def test_bank_score_kernel_matches_plain(cuda, profile, n_points):
    hw = hardware.hw1() if profile == "hw1" else _knn_hw()
    specs = [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list(),
             el.spec_btree(fanout=40)] * 7
    sweep = pack_sweep(specs, [Workload(n_entries=500_000)] * n_points,
                       [{"get": 10.0 + i, "update": 5.0}
                        for i in range(n_points)])
    f0 = sweep.frontiers[0]
    table = devicecost.device_table(hw, cuda)
    bucket = devicecost._pow2(len(f0.ids), 16)
    ids, sizes, weights, tiles = devicecost.pad_sweep(
        np.asarray(f0.ids, np.int32),
        np.stack([f.sizes for f in sweep.frontiers]),
        np.stack([f.weights for f in sweep.frontiers]),
        np.asarray(f0.tile_segments, np.int32), bucket)
    seg_tiles = np.searchsorted(tiles, np.arange(len(specs) + 1))
    args = [torch.as_tensor(a, device=cuda) for a in
            (ids, sizes, weights, seg_tiles.astype(np.int32))]
    reset_launch_counts()
    got = devicecost.bank_score(table.banks, *args, table.has_knn)
    want = devicecost.bank_score_plain(table.banks, *args, table.has_knn)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert launch_counts()["bank_score"] == 1


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
