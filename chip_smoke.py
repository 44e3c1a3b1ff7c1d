#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the Data Calculator on one GPU.

    python3 chip_smoke.py [--seed N] [--report PATH]

Builds the port's kernels from the sources in this checkout (nvcc for the
CUDA C++ kernels K1 and K3, Triton for K0), then:

* ``whatif``: the main path at full width — a design-continuum question
  (``repro_torch.core.whatif.workload_sweep``) over the depth-4
  auto-completion frontier x 64 read-fraction points on ``hw3``, a
  what-if-hardware swap to ``hw1`` (no new K0 specialisation), the
  fused totals held against the scalar oracle on a fixed cell sample
  (1e-6 relative) and the argmins against the grouped engine; then the
  same on a profile with a knn model, so K0 runs its top-4 path.
* ``kvstore``: the sorted-array and hash-table stores of
  ``examples/kv_store.py`` at 2^24 keys and 2^20 queries (half present),
  checked against a numpy oracle.
* ``kernels``: every kernel against its plain PyTorch version on the
  card, at the phases' shapes plus ragged ones, with times and bounds.

Launch counters are reset just before each path and read just after it.
Prints the card's name and power limit, one JSON line with the kernels,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is absent or any check fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: float32 operations K0 spends per (record, workload) cell of a profile
#: without knn models: clip 2, two logs, the 4-feature basis 8, four
#: sigmoids at 7 each, select and weight 4
K0_OPS_PER_CELL = 2 + 2 + 8 + 4 * 7 + 4

N_POINTS = 64
DEPTH = 4
SCALAR_SAMPLE = 128
KV_N, KV_Q = 1 << 24, 1 << 20
HASH_S, HASH_CAP = 21, 32
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` over ``reps`` launches (CUDA
    events around the batch, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# whatif: the main path
# ---------------------------------------------------------------------------
def knn_profile(base):
    """``base`` with its random-access model replaced by a k-NN over 16
    support points (what the reference's ``fit("knn")`` builds)."""
    from repro_torch.core.hardware import HardwareProfile
    from repro_torch.core.models import FittedModel
    name = "random_memory_access"
    xs = np.logspace(0.0, 11.0, 16).astype(np.float32)
    ys = base.models[name].predict(xs).astype(np.float32)
    models = dict(base.models)
    models[name] = FittedModel("knn", {"x": xs, "y": ys},
                               (float(xs.min()), float(xs.max())))
    return HardwareProfile(base.name + "+knn", models)


def check_sweep(ans, frontier, workloads, mixes, hw, rng) -> dict:
    """Finite, right shape, scalar oracle on a cell sample, grouped
    argmins."""
    from repro_torch.core import whatif
    from repro_torch.core.synthesis import cost_workload
    totals = ans.totals
    assert totals.shape == (len(workloads), len(frontier)), totals.shape
    assert np.isfinite(totals).all() and (totals > 0).all()
    cells = [(int(rng.integers(len(workloads))),
              int(rng.integers(len(frontier))))
             for _ in range(SCALAR_SAMPLE)]
    worst = 0.0
    for p, d in cells:
        scalar = cost_workload(frontier[d], workloads[p], hw, mixes[p])
        worst = max(worst, abs(totals[p, d] - scalar) / abs(scalar))
    assert worst <= 1e-6, f"fused vs scalar oracle: {worst:.3e} > 1e-6"
    grouped = whatif.workload_sweep(frontier, workloads, hw, mixes,
                                    engine="grouped")
    same = bool((grouped.best_indices == ans.best_indices).all())
    assert same, "per-point argmins differ from the grouped engine"
    rel = float(np.max(np.abs(grouped.totals - totals) / grouped.totals))
    return {"scalar_cells": len(cells), "max_rel_vs_scalar": worst,
            "max_rel_vs_grouped": rel, "argmins_match_grouped": same}


def phase_whatif(seed: int) -> dict:
    from repro_torch.core import (autocomplete, batchcost, devicecost,
                                  hardware, whatif)
    from repro_torch.core.synthesis import Workload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(seed)
    frontier = autocomplete.enumerate_frontier((), max_depth=DEPTH)
    workloads = [Workload(n_entries=1_000_000, n_queries=100)] * N_POINTS
    mixes = whatif.read_fraction_mixes(np.linspace(0.0, 1.0, N_POINTS))
    hw3, hw1 = hardware.hw3(), hardware.hw1()
    knn_hw = knn_profile(hw3)

    reset_launch_counts()
    t0 = time.perf_counter()
    ans = whatif.workload_sweep(frontier, workloads, hw3, mixes)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ans = whatif.workload_sweep(frontier, workloads, hw3, mixes)
    repeat_s = time.perf_counter() - t0
    specs_before = devicecost.specialisation_count()
    t0 = time.perf_counter()
    ans_hw1 = whatif.workload_sweep(frontier, workloads, hw1, mixes)
    swap_s = time.perf_counter() - t0
    best = ans.best(0)[0]
    swap = whatif.what_if_hardware(best, workloads[0], hw3, hw1, mixes[0])
    new_specs = devicecost.specialisation_count() - specs_before
    ans_knn = whatif.workload_sweep(frontier, workloads, knn_hw, mixes)
    launches = launch_counts()

    assert new_specs == 0, f"hardware swap added {new_specs} K0 " \
                           f"specialisations"
    assert launches.get("bank_score", 0) > 0, "K0 never launched"
    n_records = len(batchcost.pack_sweep(frontier, workloads,
                                         mixes).frontiers[0].ids)
    out = {"designs": len(frontier), "points": N_POINTS,
           "records_per_point": n_records,
           "first_sweep_s": first_s, "repeat_sweep_s": repeat_s,
           "hw1_sweep_s": swap_s, "hw_swap_new_specialisations": new_specs,
           "what_if_hardware": swap.summary(),
           "launches": launches}
    out["hw3"] = check_sweep(ans, frontier, workloads, mixes, hw3, rng)
    out["hw1"] = check_sweep(ans_hw1, frontier, workloads, mixes, hw1, rng)
    out["knn"] = check_sweep(ans_knn, frontier, workloads, mixes, knn_hw,
                             rng)
    assert devicecost.device_table(knn_hw).has_knn
    out["best_designs"] = sorted({s.describe() for s, _ in
                                  (ans.best(i) for i in range(N_POINTS))})
    return out


# ---------------------------------------------------------------------------
# kvstore: the sorted-array and hash-table stores
# ---------------------------------------------------------------------------
def kv_data(seed: int):
    rng = np.random.default_rng(seed + 1)
    keys = rng.choice(1 << 30, KV_N, replace=False).astype(np.int32)
    values = rng.integers(1, 1 << 30, KV_N).astype(np.int32)
    present = rng.choice(KV_N, KV_Q // 2, replace=False)
    absent = rng.integers(1 << 30, (1 << 31) - 1, KV_Q // 2)
    perm = rng.permutation(KV_Q)
    queries = np.concatenate([keys[present], absent]).astype(np.int32)[perm]
    exp_found = np.concatenate([np.ones(KV_Q // 2, bool),
                                np.zeros(KV_Q // 2, bool)])[perm]
    exp_vals = np.concatenate([values[present],
                               np.zeros(KV_Q // 2, np.int32)])[perm]
    return {"keys": keys, "values": values, "queries": queries,
            "found": exp_found, "vals": exp_vals}


def phase_kvstore(data) -> dict:
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.hash_probe.ops import (DEFAULT_A, build_table,
                                                    hash_probe)
    from repro_torch.kernels.hash_probe.ref import EMPTY_KEY
    from repro_torch.kernels.sorted_search.ops import sorted_get
    keys, values, queries = data["keys"], data["values"], data["queries"]
    t0 = time.perf_counter()
    order = np.argsort(keys)
    sk = torch.as_tensor(keys[order], device=DEVICE)
    sv = torch.as_tensor(values[order], device=DEVICE)
    tk, tv = build_table(keys, values, HASH_S, DEFAULT_A, HASH_CAP)
    data["table"] = (tk, tv)
    dropped = int(KV_N - (tk != EMPTY_KEY).sum())
    tk_t = torch.as_tensor(tk, device=DEVICE)
    tv_t = torch.as_tensor(tv, device=DEVICE)
    q_t = torch.as_tensor(queries, device=DEVICE)
    setup_s = time.perf_counter() - t0

    reset_launch_counts()
    found_s, val_s = sorted_get(sk, sv, q_t)
    found_h, val_h = hash_probe(tk_t, tv_t, q_t, s=HASH_S)
    launches = launch_counts()

    out = {"n_keys": KV_N, "n_queries": KV_Q, "setup_s": setup_s,
           "hash_dropped_entries": dropped, "launches": launches}
    for name, found, val in (("sorted", found_s, val_s),
                             ("hash", found_h, val_h)):
        f, v = found.cpu().numpy(), val.cpu().numpy()
        hits = int(f.sum())
        assert hits == KV_Q // 2, f"{name} store: {hits} hits"
        assert (f == data["found"]).all() and (v == data["vals"]).all(), \
            f"{name} store disagrees with the numpy oracle"
        out[f"{name}_hits"] = hits
    for k in ("sorted_search", "hash_probe"):
        assert launches.get(k, 0) > 0, f"{k} never launched"
    return out


# ---------------------------------------------------------------------------
# kernels: each kernel against its plain version, with times and bounds
# ---------------------------------------------------------------------------
def _k0_chunks(frontier, workloads, mixes):
    """The first and the last K0 chunk of the main sweep, laid out exactly
    as ``devicecost.score_sweep`` lays them out."""
    from repro_torch.core import batchcost, devicecost
    from repro_torch.core.templatecost import segment_ranges
    sweep = batchcost.pack_sweep(frontier, workloads, mixes)
    f0 = sweep.frontiers[0]
    ids = np.asarray(f0.ids, np.int32)
    sizes = np.stack([f.sizes for f in sweep.frontiers])
    weights = np.stack([f.weights for f in sweep.frontiers])
    tiles = np.asarray(f0.tile_segments)
    chunk = devicecost.sweep_chunk(len(workloads))
    out = []
    for lo in (0, (len(ids) - 1) // chunk * chunk):
        sl = slice(lo, lo + chunk)
        t_sl = slice(lo // devicecost.TILE, (lo + chunk) // devicecost.TILE)
        p = devicecost.pad_sweep(ids[sl], sizes[:, sl], weights[:, sl],
                                 tiles[t_sl],
                                 devicecost._pow2(len(ids[sl]), 16))
        seg_lo = int(p[3][0])
        n_local = int(p[3][-1]) + 1 - seg_lo
        _, cuts = segment_ranges(p[3] - seg_lo, n_local, n_local)
        out.append((p[0], p[1], p[2], cuts.astype(np.int32)))
    return out


def _ragged_k0(rng):
    """Segments of 1, 9, 17 and 3 tiles (not BLOCK_R multiples), W = 3."""
    from repro_torch.core import devicecost
    n_tiles = [1, 9, 17, 3]
    r = sum(n_tiles) * devicecost.TILE
    ids = rng.integers(0, 14, r).astype(np.int32)
    sizes = np.exp(rng.uniform(0, 20, (3, r))).astype(np.float32)
    weights = rng.uniform(0, 3, (3, r)).astype(np.float32)
    cuts = np.concatenate([[0], np.cumsum(n_tiles)]).astype(np.int32)
    return ids, sizes, weights, cuts


def _rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def kernel_k0(frontier, workloads, mixes, rng, launches) -> dict:
    import torch
    from repro_torch.core import devicecost, hardware
    tables = [devicecost.device_table(h, DEVICE)
              for h in (hardware.hw3(), knn_profile(hardware.hw3()))]
    cases = _k0_chunks(frontier, workloads, mixes) + [_ragged_k0(rng)]
    worst_rel, worst_abs = 0.0, 0.0
    for table in tables:
        for ids, sizes, weights, cuts in cases:
            args = [torch.as_tensor(a, device=DEVICE)
                    for a in (ids, sizes, weights, cuts)]
            got = devicecost.bank_score(table.banks, *args, table.has_knn)
            want = devicecost.bank_score_plain(table.banks, *args,
                                               table.has_knn)
            torch.cuda.synchronize()
            worst_rel = max(worst_rel, _rel_err(got, want))
            worst_abs = max(worst_abs,
                            float((got.double() - want.double()).abs().max()))
    assert worst_rel <= 1e-6, f"K0 vs plain: {worst_rel:.3e} > 1e-6"
    # time the main path's launch shape: the first [W, chunk] chunk, hw3
    table = tables[0]
    ids, sizes, weights, cuts = [torch.as_tensor(a, device=DEVICE)
                                 for a in cases[0]]
    ms = timed_ms(lambda: devicecost.bank_score(table.banks, ids, sizes,
                                                weights, cuts, False))
    plain_ms = timed_ms(lambda: devicecost.bank_score_plain(
        table.banks, ids, sizes, weights, cuts, False))
    w_axis, r = sizes.shape
    n_seg = cuts.shape[0] - 1
    n_bytes = 4 * r + 8 * w_axis * r + 4 * (n_seg + 1) + 4 * w_axis * n_seg
    n_ops = w_axis * r * K0_OPS_PER_CELL
    return _row("K0 bank_score", "triton",
                "src/repro_torch/core/devicecost.py",
                "src/repro/core/devicecost.py:328 (bank_predict, "
                "_score_kernel :369, _sweep_kernel :384)",
                launches.get("bank_score", 0), worst_abs, ms, plain_ms,
                n_bytes, n_ops, None,
                {"max_rel_err": worst_rel,
                 "shape": f"W={w_axis} R={r} segments={n_seg}"})


def _touched_keys(keys_sorted: np.ndarray, queries: np.ndarray) -> int:
    """Distinct keys the branchless upper-bound searches of this run read
    (the same loop as csrc/sorted_search.cu, vectorized)."""
    n = len(keys_sorted)
    base = np.zeros(len(queries), np.int64)
    length = n
    seen = []
    while length > 1:
        half = length >> 1
        probe = base + half
        seen.append(np.unique(probe))
        base = np.where(keys_sorted[probe] <= queries, probe, base)
        length -= half
    seen.append(np.unique(base))
    return int(len(np.unique(np.concatenate(seen))))


def kernel_k1(data, rng, launches) -> dict:
    import torch
    from repro_torch.kernels.sorted_search import kernel, ref
    keys, values, queries = data["keys"], data["values"], data["queries"]
    order = np.argsort(keys)
    sk_np = keys[order]
    sk = torch.as_tensor(sk_np, device=DEVICE)
    sv = torch.as_tensor(values[order], device=DEVICE)
    q = torch.as_tensor(queries, device=DEVICE)
    cases = [(sk, sv, q)]
    for dtype in (np.int32, np.int64, np.float32):
        k = np.sort(rng.integers(0, 1 << 22, 1_000_003)).astype(dtype)
        qq = rng.integers(-5, (1 << 22) + 5, 77_777).astype(dtype)
        cases.append(tuple(torch.as_tensor(a, device=DEVICE) for a in
                           (k, np.arange(len(k), dtype=np.int64), qq)))
    edge = np.asarray([7], np.int32)
    cases.append(tuple(torch.as_tensor(a, device=DEVICE) for a in
                       (edge, edge, np.asarray([6, 7, 8], np.int32))))
    mismatches = 0
    for k, v, qq in cases:
        mismatches += int((kernel.sorted_search_kernel(k, qq)
                           != ref.sorted_search_ref(k, qq)).sum())
        f1, v1 = kernel.sorted_get_kernel(k, v, qq)
        f2, v2 = ref.sorted_get_ref(k, v, qq)
        mismatches += int((f1 != f2).sum()) + int((v1 != v2).sum())
    assert mismatches == 0, f"K1 vs plain: {mismatches} mismatches"
    ms = timed_ms(lambda: kernel.sorted_search_kernel(sk, q))
    plain_ms = timed_ms(lambda: ref.sorted_search_ref(sk, q))
    library_ms = timed_ms(lambda: torch.searchsorted(sk, q, right=True))
    get_ms = timed_ms(lambda: kernel.sorted_get_kernel(sk, sv, q))
    get_plain_ms = timed_ms(lambda: ref.sorted_get_ref(sk, sv, q))
    n_q = len(queries)
    touched = _touched_keys(sk_np, queries)
    n_bytes = 4 * n_q + 4 * n_q + 4 * touched
    n_ops = n_q * math.ceil(math.log2(len(keys)))
    return _row("K1 sorted_search", "cuda",
                "src/repro_torch/csrc/sorted_search.cu",
                "src/repro/kernels/sorted_search/kernel.py:45 "
                "(sorted_search_kernel, _search_kernel :31)",
                launches.get("sorted_search", 0), 0.0, ms, plain_ms,
                n_bytes, n_ops, library_ms,
                {"shape": f"N={len(keys)} Q={n_q}",
                 "keys_touched": touched, "sorted_get_ms": get_ms,
                 "sorted_get_plain_ms": get_plain_ms})


def kernel_k3(data, rng, launches) -> dict:
    import torch
    from repro_torch.kernels.hash_probe import kernel, ref
    from repro_torch.kernels.hash_probe.ops import DEFAULT_A
    keys, queries = data["keys"], data["queries"]
    tk, tv = data["table"]
    main = (torch.as_tensor(tk, device=DEVICE),
            torch.as_tensor(tv, device=DEVICE),
            torch.as_tensor(queries, device=DEVICE), HASH_S)
    cases = [main]
    for s, cap, n, nq in ((7, 40, 3000, 1001), (1, 3, 5, 33),
                          (10, 8, 9000, 4097)):
        k = rng.choice(1 << 20, n, replace=False)
        t_k, t_v = ref.build_table(k, k * 3 + 1, s, DEFAULT_A, cap)
        qq = np.concatenate([k[: nq // 2], rng.integers(1 << 21, 1 << 22,
                                                        nq - nq // 2)])
        qq[0] = ref.EMPTY_KEY          # the reference's empty-slot match
        cases.append((torch.as_tensor(t_k, device=DEVICE),
                      torch.as_tensor(t_v, device=DEVICE),
                      torch.as_tensor(qq.astype(np.int32), device=DEVICE),
                      s))
    mismatches = 0
    for t_k, t_v, qq, s in cases:
        p1, v1 = kernel.hash_probe_kernel(t_k, t_v, qq, DEFAULT_A, s)
        p2, v2 = ref.hash_probe_ref(t_k, t_v, qq, DEFAULT_A, s)
        mismatches += int((p1 != p2).sum()) + int((v1 != v2).sum())
    assert mismatches == 0, f"K3 vs plain: {mismatches} mismatches"
    t_k, t_v, qq, s = main
    ms = timed_ms(lambda: kernel.hash_probe_kernel(t_k, t_v, qq, DEFAULT_A,
                                                   s))
    plain_ms = timed_ms(lambda: ref.hash_probe_ref(t_k, t_v, qq, DEFAULT_A,
                                                   s))
    buckets = ref.multiply_shift_np(queries, DEFAULT_A, HASH_S)
    hits = int((kernel.hash_probe_kernel(t_k, t_v, qq, DEFAULT_A, s)[0]
                != kernel.NOT_FOUND).sum())
    n_q = len(queries)
    n_bytes = (len(np.unique(buckets)) * HASH_CAP * 4 + 4 * hits
               + 4 * n_q + 8 * n_q)
    return _row("K3 hash_probe", "cuda", "src/repro_torch/csrc/hash_probe.cu",
                "src/repro/kernels/hash_probe/kernel.py:69 "
                "(hash_probe_kernel, _probe_kernel :40)",
                launches.get("hash_probe", 0), 0.0, ms, plain_ms, n_bytes,
                n_q * 2 * HASH_CAP, None,
                {"shape": f"table=[2^{HASH_S},{HASH_CAP}] Q={n_q}"})


def _row(name, route, source, replaces, launches, max_abs_err, ms,
         plain_ms, n_bytes, n_ops, library_ms, extra) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max_abs_err, "ms": ms, "kernel_ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "bytes": n_bytes, "ops": n_ops}
    row.update(extra)
    return row


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", default=None,
                        help="also write the full report as JSON here")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch import runtime
    from repro_torch.core import autocomplete, whatif
    from repro_torch.core.synthesis import Workload
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime.set_device("cuda")
    t_start = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    build.build()
    report["nvcc_build_s"] = time.perf_counter() - t0
    for name in build.SOURCES:
        for line in build.build_log(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    report["whatif"] = phase_whatif(args.seed)
    report["whatif"]["phase_s"] = time.perf_counter() - t0
    log("whatif: " + json.dumps({k: v for k, v in report["whatif"].items()
                                 if k != "best_designs"}))

    t0 = time.perf_counter()
    data = kv_data(args.seed)
    report["kvstore"] = phase_kvstore(data)
    report["kvstore"]["phase_s"] = time.perf_counter() - t0
    log("kvstore: " + json.dumps(report["kvstore"]))

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 2)
    frontier = autocomplete.enumerate_frontier((), max_depth=DEPTH)
    workloads = [Workload(n_entries=1_000_000, n_queries=100)] * N_POINTS
    mixes = whatif.read_fraction_mixes(np.linspace(0.0, 1.0, N_POINTS))
    kernels = [
        kernel_k0(frontier, workloads, mixes, rng,
                  report["whatif"]["launches"]),
        kernel_k1(data, rng, report["kvstore"]["launches"]),
        kernel_k3(data, rng, report["kvstore"]["launches"]),
    ]
    report["kernels_phase_s"] = time.perf_counter() - t0
    report["total_s"] = time.perf_counter() - t_start

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    smi = smi.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=1, default=str)
    log(f"total {report['total_s']:.1f}s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
