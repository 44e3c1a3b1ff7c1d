#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the Data Calculator on one GPU.

    python3 chip_smoke.py [--seed N] [--report PATH]

Builds the port's kernels from the sources in this checkout (one nvcc per
CUDA C++ source, all at once, for K1-K5; Triton for K0), then:

* ``whatif``: the main path at full width — a design-continuum question
  (``repro_torch.core.whatif.workload_sweep``) over the depth-4
  auto-completion frontier x 64 read-fraction points on ``hw3``, a
  what-if-hardware swap to ``hw1`` (no new K0 specialisation), the
  fused totals held against the scalar oracle on a fixed cell sample
  (1e-6 relative) and the argmins against the grouped engine; then the
  same on a profile with a knn model, so K0 runs its top-4 path.  Each
  sweep is one K0 launch; one more repeat question is traced with
  ``torch.profiler`` (K0's device time, host-to-device copies, the
  card's busy share).
* ``kvstore``: the three stores of ``examples/kv_store.py``: sorted array
  (K1) and hash table (K3) at 2^24 keys and 2^20 queries, and the log with
  a bloom filter (K4 skips misses in one launch of its mask variant, K2
  scans the log for the rest) at 2^20 keys and 2^16 queries; half of each
  query set present, checked against a numpy oracle.
* ``lm``: qwen2-1.5b at its published widths (28 layers, random weights
  from ``--seed``, float32 parameters, bf16 compute, flash attention) serves
  4 prompts of 2,048 tokens: the fused prefill (K5, all 28 launches on its
  bf16 tensor-core variant) and 32 greedy decode steps through
  ``repro_torch.launch.serve.serve_batch``; the prefill is
  held against the plain chunked-attention path on the same weights
  (float32 compute: logits and KV cache within 5e-2; bf16 compute: no
  further from the float32 logits than the plain path); one prefill and
  four decode steps are traced with ``torch.profiler``.
* ``kernels``: every kernel against its plain PyTorch version on the
  card, at the phases' shapes plus ragged ones, with times and bounds;
  K1 also at its edges (N around its shared tree's size, N = 1-33, runs of
  duplicates, the dtype's extremes, unaligned keys, 2^20 queries) with
  its bound in 32-byte sectors of the keys that fix each rank (the search
  path's sectors beside it), the Get's time and bound and the tree
  depth; K4's hits and mask variants, and the bloom_probe op's device
  time, host time per call and the kernels one call launched (traced).

Launch counters are reset just before each path and read just after it.
Prints the card's name and power limit, one JSON line with the kernels,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is absent or any check fails.
``--only whatif`` runs the whatif phase alone and ``--only stores`` times
K1 and the bloom_probe op at the kvstore shapes; both print no result
line.
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

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 (non-tensor),
#: bf16 dense tensor cores; INT32 throughput from the Hopper white paper:
#: 64 INT32 lanes per SM x 132 SMs x the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
PEAKS = {"fp32": FP32_OPS_PER_S, "bf16_tensor": BF16_TC_OPS_PER_S,
         "int32": INT32_OPS_PER_S}

#: float32 operations K0 spends per (record, workload) cell of a profile
#: without knn models: clip 2, two logs, the 4-feature basis 8, four
#: sigmoids at 7 each, select and weight 4
K0_OPS_PER_CELL = 2 + 2 + 8 + 4 * 7 + 4

#: integer operations K2 spends per (key, query) pair: the equality
#: compare, the two bound compares and the count add
K2_OPS_PER_PAIR = 4

N_POINTS = 64
DEPTH = 4
SCALAR_SAMPLE = 128
KV_N, KV_Q = 1 << 24, 1 << 20
HASH_S, HASH_CAP = 21, 32
#: the log+bloom store: a log is an unsorted column that Get scans, O(N Q)
#: by the reference's design (that is what a log costs), so it holds 2^20
#: keys where the sorted and hash stores hold 2^24; a 2^24-bit (2 MB)
#: filter, 16 bits a key, with k = 3 hashes as examples/kv_store.py uses
LOG_N, LOG_Q = 1 << 20, 1 << 16
BLOOM_S, BLOOM_K = 24, 3
#: the lm phase: 4 prompts of 2,048 tokens, then 32 decode steps
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
#: the reference's flash-vs-xla tolerance (tests/test_arch_smoke.py)
LM_TOL = 5e-2
DEVICE = "cuda"
#: device clock cycles (~25 ms) timed_ms holds the stream before a timed
#: batch, longer than the host takes to queue 20 launches of any kernel
SLEEP_CYCLES = 50_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` over ``reps`` launches (CUDA
    events around the batch, after warm-up).  The batch is queued behind
    a device-side sleep, so a kernel shorter than its own launch on the
    host is timed back to back, not at the host's launch pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
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


def phase_whatif(seed: int, one_launch: bool = True) -> dict:
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

    sweep_launches = []

    def sweep(hw):
        """One design-continuum question: its answer, its host-clock
        seconds, and the K0 launches it made (kept in sweep_launches)."""
        before = launch_counts().get("bank_score", 0)
        t0 = time.perf_counter()
        answer = whatif.workload_sweep(frontier, workloads, hw, mixes)
        took = time.perf_counter() - t0
        sweep_launches.append(launch_counts().get("bank_score", 0) - before)
        return answer, took

    reset_launch_counts()
    ans, first_s = sweep(hw3)
    ans, repeat_s = sweep(hw3)
    specs_before = devicecost.specialisation_count()
    ans_hw1, swap_s = sweep(hw1)
    best = ans.best(0)[0]
    swap = whatif.what_if_hardware(best, workloads[0], hw3, hw1, mixes[0])
    new_specs = devicecost.specialisation_count() - specs_before
    ans_knn, _ = sweep(knn_hw)
    launches = launch_counts()
    # where a repeat question's time goes: one more, traced (after the
    # counters are read, so they hold the path's own launches)
    profile_repeat = _profile(
        lambda: whatif.workload_sweep(frontier, workloads, hw3, mixes), 1,
        watch="bank_score")

    assert new_specs == 0, f"hardware swap added {new_specs} K0 " \
                           f"specialisations"
    assert launches.get("bank_score", 0) > 0, "K0 never launched"
    assert sweep_launches == [1] * 4 or not one_launch, \
        f"K0 launches per sweep: {sweep_launches}, not one each"
    n_records = len(batchcost.pack_sweep(frontier, workloads,
                                         mixes).frontiers[0].ids)
    out = {"designs": len(frontier), "points": N_POINTS,
           "records_per_point": n_records,
           "first_sweep_s": first_s, "repeat_sweep_s": repeat_s,
           "hw1_sweep_s": swap_s, "hw_swap_new_specialisations": new_specs,
           "what_if_hardware": swap.summary(),
           "launches": launches, "k0_launches_per_sweep": sweep_launches,
           "profile_repeat": profile_repeat,
           # traced device time over the untraced repeat's host clock
           "repeat_device_busy_share":
               profile_repeat["device_ms_per_step"] / (repeat_s * 1e3)}
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
def _store_data(rng, n: int, q: int) -> dict:
    """n distinct int32 keys below 2^30 with values, q queries of which
    half are keys and half are drawn above the key range."""
    keys = rng.choice(1 << 30, n, replace=False).astype(np.int32)
    values = rng.integers(1, 1 << 30, n).astype(np.int32)
    present = rng.choice(n, q // 2, replace=False)
    absent = rng.integers(1 << 30, (1 << 31) - 1, q // 2)
    perm = rng.permutation(q)
    queries = np.concatenate([keys[present], absent]).astype(np.int32)[perm]
    exp_found = np.concatenate([np.ones(q // 2, bool),
                                np.zeros(q // 2, bool)])[perm]
    exp_vals = np.concatenate([values[present],
                               np.zeros(q // 2, np.int32)])[perm]
    return {"keys": keys, "values": values, "queries": queries,
            "found": exp_found, "vals": exp_vals}


def kv_data(seed: int):
    data = _store_data(np.random.default_rng(seed + 1), KV_N, KV_Q)
    data["log"] = _store_data(np.random.default_rng(seed + 3), LOG_N, LOG_Q)
    return data


def phase_kvstore(data) -> dict:
    """The three stores."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.bloom_probe.ops import (DEFAULT_COEFFS,
                                                     bloom_probe,
                                                     build_filter,
                                                     filter_words)
    from repro_torch.kernels.hash_probe.ops import (DEFAULT_A, build_table,
                                                    hash_probe)
    from repro_torch.kernels.hash_probe.ref import EMPTY_KEY
    from repro_torch.kernels.scan_filter.ops import scan_get
    from repro_torch.kernels.sorted_search.ops import sorted_get
    keys, values, queries = data["keys"], data["values"], data["queries"]
    lg = data["log"]
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
    words = build_filter(lg["keys"], DEFAULT_COEFFS[:BLOOM_K], BLOOM_S)
    lg["words"] = words
    w_t = filter_words(words, DEVICE)
    lk_t = torch.as_tensor(lg["keys"], device=DEVICE)
    lv_t = torch.as_tensor(lg["values"], device=DEVICE)
    lq_t = torch.as_tensor(lg["queries"], device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reset_launch_counts()
    found_s, val_s = sorted_get(sk, sv, q_t)
    found_h, val_h = hash_probe(tk_t, tv_t, q_t, s=HASH_S)
    t0 = time.perf_counter()
    maybe = bloom_probe(w_t, lq_t, s=BLOOM_S, num_hashes=BLOOM_K)
    passed = lq_t[maybe]                          # a ragged count
    found_l, val_l = scan_get(lk_t, lv_t, passed)
    torch.cuda.synchronize()
    log_s = time.perf_counter() - t0
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

    m = maybe.cpu().numpy()
    assert m[lg["found"]].all(), "bloom filter: a false negative"
    from repro_torch.kernels.bloom_probe.ref import _hashes
    hv = _hashes(lg["queries"], DEFAULT_COEFFS[:BLOOM_K], BLOOM_S)
    bits = (words[hv >> 5] >> (hv & 31).astype(np.uint32)) & 1
    assert (m == bits.all(axis=1)).all(), \
        "bloom membership disagrees with the numpy oracle"
    f, v = found_l.cpu().numpy(), val_l.cpu().numpy()
    hits = int(f.sum())
    assert hits == LOG_Q // 2, f"log+bloom store: {hits} hits"
    assert (f == lg["found"][m]).all() and (v == lg["vals"][m]).all(), \
        "log+bloom store disagrees with the numpy oracle"
    lg["maybe"] = m
    out["log"] = {"n_keys": LOG_N, "n_queries": LOG_Q,
                  "filter_bits": 1 << BLOOM_S, "hashes": BLOOM_K,
                  "log_hits": hits, "bloom_passed": int(m.sum()),
                  "bloom_false_positives": int(m.sum()) - LOG_Q // 2,
                  "bloom_skipped_misses": int((~m).sum()),
                  "misses": LOG_Q // 2, "probe_s": log_s}
    for k in ("sorted_search", "hash_probe", "scan_filter"):
        assert launches.get(k, 0) > 0, f"{k} never launched"
    # the membership probe is one launch of K4's mask variant
    assert launches.get("bloom_probe_mask", 0) == 1 and \
        launches.get("bloom_probe", 0) == 0, \
        f"the log path's K4 launches: {launches}"
    return out


# ---------------------------------------------------------------------------
# lm: qwen2-1.5b prefill (K5) and greedy decode
# ---------------------------------------------------------------------------
def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _within(a, b, tol: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def _profile(fn, steps: int, watch: str = "") -> dict:
    """torch.profiler over ``steps`` calls of ``fn``: device and host time
    per call, the kernels that take the most device time, the host-to-
    device copies, and the device time of each launch of the kernels
    whose name holds ``watch``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device work is counted on the kernels' own (CUDA) events only: the
    # operator events that launched them report the same time again
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    device_us = sum(dev(e) for e in kernels)
    host_us = sum(e.self_cpu_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU)
    top = sorted(kernels, key=dev, reverse=True)[:8]
    # (the host time is inflated by the profiler's own work)
    out = {"steps": steps, "device_ms_per_step": device_us / 1e3 / steps,
           "host_ms_per_step": host_us / 1e3 / steps,
           "wall_ms_per_step": wall_ms / steps,
           "device_busy_share_traced": device_us / 1e3 / wall_ms,
           "htod_copy_ms_per_step": sum(
               dev(e) for e in kernels if "HtoD" in e.key) / 1e3 / steps,
           "device_events_per_step": sum(e.count for e in kernels) / steps,
           "top_kernels_ms_per_step": {
               e.key[:60]: dev(e) / 1e3 / steps for e in top},
           "launches_per_step": sum(
               e.count for e in events if e.key == "cudaLaunchKernel") /
           steps}
    if watch:
        each = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and watch in e.name]
        out[f"{watch}_launches_per_step"] = len(each) / steps
        out[f"{watch}_ms_per_step"] = sum(each) / steps
        out[f"{watch}_ms_each"] = each
    return out


def phase_lm(seed: int) -> dict:
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build
    from repro_torch.train.serve import make_prefill_step, make_serve_step
    cfg = dataclasses.replace(qwen2_1_5b.config(), attn_impl="flash")
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 4)
    prompts = rng.integers(0, cfg.vocab_size,
                           (LM_BATCH, LM_PROMPT)).astype(np.int32)
    max_len = LM_PROMPT + LM_DECODE
    # warm cuBLAS and the kernel once, so the timed run is the steady one
    serve_batch(cfg, prompts[:, :128], 2, params=params, log=lambda _: None)

    reset_launch_counts()
    run = serve_batch(cfg, prompts, LM_DECODE + 1, params=params,
                      max_len=max_len, log=log)
    launches = launch_counts()
    repeat = serve_batch(cfg, prompts, LM_DECODE + 1, params=params,
                         max_len=max_len, log=lambda _: None)

    tokens = run["tokens"]
    assert launches.get("flash_attention", 0) == cfg.n_layers, \
        f"K5 launched {launches.get('flash_attention', 0)} times in one " \
        f"prefill, expected {cfg.n_layers}"
    assert launches.get("flash_attention_wgmma", 0) == cfg.n_layers, \
        f"the bf16 prefill launched K5's tensor-core variant " \
        f"{launches.get('flash_attention_wgmma', 0)} times, expected " \
        f"{cfg.n_layers}: {launches}"
    assert tokens.shape == (LM_BATCH, LM_DECODE + 1), tokens.shape
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    assert (tokens == repeat["tokens"]).all(), "a repeat run gave other tokens"
    assert torch.isfinite(run["prefill_logits"].float()).all()

    # the prefill against the plain path (chunked attention, no kernel),
    # with the same weights: in float32 compute, where the two differ only
    # by the kernel's arithmetic, within the reference's flash-vs-xla
    # tolerance; in bf16 compute (the served run) bf16 rounding of the
    # whole 28-layer model moves both paths as far from the float32
    # logits as they are from each other, so there the flash path must be
    # no further from the float32 logits than the plain path is
    prompt_t = torch.as_tensor(prompts, device=DEVICE)
    res = {}
    with torch.no_grad():
        for impl in ("flash", "xla"):
            for dtype in ("float32", "bfloat16"):
                m = build(dataclasses.replace(cfg, attn_impl=impl,
                                              compute_dtype=dtype))
                logits, cache = make_prefill_step(m, max_len)(params,
                                                              prompt_t)
                res[impl, dtype] = (logits.float(), cache)
    torch.cuda.synchronize()
    truth = res["xla", "float32"][0]

    def rms(a, b):
        return float((a.float() - b.float()).pow(2).mean().sqrt())

    f32 = {"logits_max_abs": _max_abs(res["flash", "float32"][0], truth)}
    for name in ("k", "v"):
        f32[f"cache_{name}_max_abs"] = _max_abs(
            res["flash", "float32"][1][name], res["xla", "float32"][1][name])
    bf16 = {"flash_vs_plain_max_abs": _max_abs(res["flash", "bfloat16"][0],
                                               res["xla", "bfloat16"][0]),
            "flash_vs_plain_rms": rms(res["flash", "bfloat16"][0],
                                      res["xla", "bfloat16"][0])}
    for impl in ("flash", "xla"):
        bf16[f"{impl}_vs_float32_max_abs"] = _max_abs(
            res[impl, "bfloat16"][0], truth)
        bf16[f"{impl}_vs_float32_rms"] = rms(res[impl, "bfloat16"][0], truth)
    for name in ("k", "v"):
        bf16[f"cache_{name}_flash_vs_plain_max_abs"] = _max_abs(
            res["flash", "bfloat16"][1][name], res["xla", "bfloat16"][1][name])
    out = {"arch": cfg.arch_id, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": f"{cfg.n_heads}/{cfg.n_kv_heads}",
           "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
           "init_s": init_s, "prefill_s": run["prefill_s"],
           "decode_s": run["decode_s"],
           "decode_tok_s": LM_BATCH * LM_DECODE / run["decode_s"],
           "prefill_tok_s": LM_BATCH * LM_PROMPT / run["prefill_s"],
           "launches": launches, "float32_compute": f32,
           "bfloat16_compute": bf16, "same_tokens_on_repeat": True,
           "first_tokens": tokens[:, :8].tolist()}
    assert _max_abs(res["flash", "bfloat16"][0], run["prefill_logits"]) == 0
    f_res, x_res = res["flash", "float32"], res["xla", "float32"]
    assert _within(f_res[0], x_res[0], LM_TOL), \
        f"flash vs plain prefill logits (float32 compute): {f32}"
    for name in ("k", "v"):
        assert _within(f_res[1][name], x_res[1][name], LM_TOL), \
            f"flash vs plain prefill cache {name} (float32 compute): {f32}"
    assert bf16["flash_vs_float32_rms"] <= 1.25 * bf16["xla_vs_float32_rms"], \
        f"bf16 flash prefill further from float32 than the plain path: {bf16}"
    # where the time goes: a trace of one prefill and four decode steps
    del res
    prefill = make_prefill_step(model, max_len)
    step = make_serve_step(model)
    with torch.no_grad():
        logits, cache = prefill(params, prompt_t)
        token = logits.argmax(-1).to(torch.int32)
        pos = torch.full((LM_BATCH,), LM_PROMPT, dtype=torch.int32,
                         device=DEVICE)
        step(params, cache, token, pos)
        out["profile_prefill"] = _profile(lambda: prefill(params, prompt_t),
                                          1)
        out["profile_decode"] = _profile(
            lambda: step(params, cache, token, pos), 4)
    # device-busy shares: traced device time over the untraced run's
    # host-clock time of the same work
    out["prefill_device_busy_share"] = (
        out["profile_prefill"]["device_ms_per_step"] /
        (run["prefill_s"] * 1e3))
    out["decode_device_busy_share"] = (
        out["profile_decode"]["device_ms_per_step"] /
        (run["decode_s"] * 1e3 / LM_DECODE))
    return out


# ---------------------------------------------------------------------------
# kernels: each kernel against its plain version, with times and bounds
# ---------------------------------------------------------------------------
def _ragged_k0(rng):
    """Designs of 1-6 tiles and longer than K0's record block (9 and 17
    tiles), one empty design; W = 67 (not a multiple of its row block)."""
    import torch
    from repro_torch.core import devicecost
    n_tiles = [1, 2, 3, 4, 5, 6, 0, 9, 17, 3]
    r = sum(n_tiles) * devicecost.TILE
    ids = rng.integers(0, 14, r).astype(np.int32)
    sizes = np.exp(rng.uniform(0, 20, (67, r))).astype(np.float32)
    weights = rng.uniform(0, 3, (67, r)).astype(np.float32)
    cuts = np.concatenate([[0], np.cumsum(n_tiles)]).astype(np.int32)
    return [torch.as_tensor(a, device=DEVICE)
            for a in (ids, sizes, weights, cuts)]


def _rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def kernel_k0(frontier, workloads, mixes, rng, launches) -> dict:
    import torch
    from repro_torch.core import batchcost, devicecost, hardware
    dev = torch.device(DEVICE)
    tables = [devicecost.device_table(h, DEVICE)
              for h in (hardware.hw3(), knn_profile(hardware.hw3()))]
    # the path's own layouts: the whole sweep (W = 64) and its first
    # point as a flat frontier (W = 1), real records only
    sweep = batchcost.pack_sweep(frontier, workloads, mixes)
    main = sweep._sweep_arrays(dev).arrays
    cases = [main, sweep.frontiers[0]._device_sweep(dev).arrays,
             _ragged_k0(rng)]
    worst_rel, worst_abs = 0.0, 0.0
    for table in tables:
        for args in cases:
            got = devicecost.bank_score(table.banks, *args, table.has_knn)
            want = devicecost.bank_score_plain(table.banks, *args,
                                               table.has_knn)
            torch.cuda.synchronize()
            worst_rel = max(worst_rel, _rel_err(got, want))
            worst_abs = max(worst_abs,
                            float((got.double() - want.double()).abs().max()))
    assert worst_rel <= 1e-6, f"K0 vs plain: {worst_rel:.3e} > 1e-6"
    # time the main path's launch: the whole [W, R] sweep, hw3
    table = tables[0]
    ids, sizes, weights, cuts = main
    ms = timed_ms(lambda: devicecost.bank_score(table.banks, ids, sizes,
                                                weights, cuts, False))
    plain_ms = timed_ms(lambda: devicecost.bank_score_plain(
        table.banks, ids, sizes, weights, cuts, False), reps=5)
    knn_table = tables[1]
    knn_ms = timed_ms(lambda: devicecost.bank_score(
        knn_table.banks, ids, sizes, weights, cuts, True))
    w_axis, r = sizes.shape
    n_seg = cuts.shape[0] - 1
    n_bytes = 4 * r + 8 * w_axis * r + 4 * (n_seg + 1) + 4 * w_axis * n_seg
    n_ops = w_axis * r * K0_OPS_PER_CELL
    return _row("K0 bank_score", "triton",
                "src/repro_torch/core/devicecost.py",
                "src/repro/core/devicecost.py:328 (bank_predict, "
                "_score_kernel :369, _sweep_kernel :384)",
                launches.get("bank_score", 0), worst_abs, ms, plain_ms,
                n_bytes, n_ops, "fp32", None,
                {"max_rel_err": worst_rel, "knn_ms": knn_ms,
                 "shape": f"W={w_axis} R={r} segments={n_seg} (the whole "
                          f"sweep, real records only)"})


def _search_probes(keys_sorted: np.ndarray, queries: np.ndarray):
    """Every position the branchless upper-bound searches of this run
    read, level by level (the loop at the top of csrc/sorted_search.cu,
    vectorized), and the ranks (clamped to N).  The search path's traffic
    is this algorithm's, not the function's: it is reported beside the
    bound, not in it."""
    n = len(keys_sorted)
    base = np.zeros(len(queries), np.int64)
    length = n
    probes = []
    while length > 1:
        half = length >> 1
        probe = base + half
        probes.append(np.unique(probe))
        base = np.where(keys_sorted[probe] <= queries, probe, base)
        length -= half
    probes.append(np.unique(base))
    rank = base + (keys_sorted[base] <= queries)
    return np.unique(np.concatenate(probes)), rank


def _sectors(positions: np.ndarray, itemsize: int) -> int:
    """Distinct 32-byte sectors that hold these element positions (of an
    array that starts on a sector)."""
    return int(len(np.unique(positions * itemsize // 32)))


def _bracket(rank: np.ndarray, n: int) -> np.ndarray:
    """The positions that fix each rank, whatever the search: keys[rank -
    1] (<= the query) where rank > 0 and keys[rank] (> it) where rank <
    N."""
    return np.concatenate([rank[rank > 0] - 1, rank[rank < n]])


def _k1_cases(rng, tree_depth):
    """(keys, values, queries) numpy triples at K1's edges: N below, at
    and above 2^tree_depth(dtype) (its shared tree's size), N = 1, 2, 31,
    32, 33, long runs of duplicates, queries below the minimum, above the
    maximum and equal to the dtype's maximum; for float32 the infinities
    and both zeros."""
    cases = []
    for dtype in (np.int32, np.int64, np.float32):
        info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
        extremes = [info.min, info.max, -1, 0]
        if dtype == np.float32:
            extremes += [-np.inf, np.inf, -0.0, 0.0]
        extremes = np.asarray(extremes, dtype)
        top = tree_depth(dtype)
        # (n, key range, random queries): 2^20 queries are more tiles of
        # the persistent grid than the card has SMs for every dtype
        for n, hi, nq in ((1_000_003, 1 << 22, 77_777),
                          (1 << 22, 1 << 26, 1 << 20),
                          (2**top - 1, 1 << 20, 7_777),
                          (2**top, 1 << 20, 7_777),
                          (2**top + 1, 1 << 20, 7_777), (1, 4, 7_777),
                          (2, 4, 7_777), (31, 8, 7_777), (32, 8, 7_777),
                          (33, 8, 7_777), (70_001, 50, 7_777)):
            k = np.sort(rng.integers(0, hi, n)).astype(dtype)
            qq = np.concatenate([rng.integers(-5, hi + 5, nq)
                                 .astype(dtype), extremes])
            cases.append((k, np.arange(n, dtype=np.int64), qq))
        runs = [(-5, 3000), (0, 1), (7, 5000), (8, 4096), (info.max, 33)]
        if dtype == np.float32:
            runs = [(-np.inf, 2), (-0.0, 40), (0.0, 41)] + runs + \
                [(np.inf, 3)]
        k = np.concatenate([np.full(c, v, dtype) for v, c in runs])
        qq = np.concatenate([np.asarray([-6, -5, 6, 7, 8, 9], dtype),
                             extremes])
        cases.append((k, np.arange(len(k), dtype=np.int32), qq))
    cases.append((np.asarray([7], np.int32), np.asarray([7], np.int32),
                  np.asarray([6, 7, 8], np.int32)))
    return cases


def _k1_mismatches(kernel, ref, k, v, qq) -> int:
    mismatches = int((kernel.sorted_search_kernel(k, qq)
                      != ref.sorted_search_ref(k, qq)).sum())
    f1, v1 = kernel.sorted_get_kernel(k, v, qq)
    f2, v2 = ref.sorted_get_ref(k, v, qq)
    return mismatches + int((f1 != f2).sum()) + int((v1 != v2).sum())


def k1_times(sk, sv, q) -> dict:
    """K1 at the kvstore shape: the search, the Get, their plain versions
    and torch.searchsorted (the same calls in this and older trees)."""
    import torch
    from repro_torch.kernels.sorted_search import kernel, ref
    return {"ms": timed_ms(lambda: kernel.sorted_search_kernel(sk, q)),
            "plain_ms": timed_ms(lambda: ref.sorted_search_ref(sk, q)),
            "library_ms": timed_ms(
                lambda: torch.searchsorted(sk, q, right=True)),
            "sorted_get_ms": timed_ms(
                lambda: kernel.sorted_get_kernel(sk, sv, q)),
            "sorted_get_plain_ms": timed_ms(
                lambda: ref.sorted_get_ref(sk, sv, q))}


def kernel_k1(data, rng, launches) -> dict:
    import torch
    from repro_torch.kernels.sorted_search import kernel, ref
    keys, values, queries = data["keys"], data["values"], data["queries"]
    order = np.argsort(keys)
    sk_np, sv_np = keys[order], values[order]
    sk = torch.as_tensor(sk_np, device=DEVICE)
    sv = torch.as_tensor(sv_np, device=DEVICE)
    q = torch.as_tensor(queries, device=DEVICE)
    mismatches = _k1_mismatches(kernel, ref, sk, sv, q)
    n_cases = 1

    def tree_depth(dtype):
        """The most levels K1's shared tree holds for keys of ``dtype``."""
        return kernel.top_levels(1 << 30, torch.from_numpy(
            np.zeros(1, dtype)).dtype)

    for k, v, qq in _k1_cases(rng, tree_depth):
        k, v, qq = (torch.as_tensor(a, device=DEVICE) for a in (k, v, qq))
        mismatches += _k1_mismatches(kernel, ref, k, v, qq)
        # the same keys off 16-byte alignment: the scalar window
        buf = torch.empty(k.shape[0] + 1, dtype=k.dtype, device=DEVICE)
        buf[1:] = k
        mismatches += _k1_mismatches(kernel, ref, buf[1:], v, qq)
        n_cases += 2
    assert mismatches == 0, f"K1 vs plain: {mismatches} mismatches"
    times = k1_times(sk, sv, q)
    # where a search's time goes: its two kernels, each launch traced
    # (median of 5)
    traced = {}
    for name in ("tree_kernel", "search_kernel"):
        each = _profile(lambda: kernel.sorted_search_kernel(sk, q), 5,
                        watch=name)[f"{name}_ms_each"]
        traced[name] = float(np.median(each)) if each else None
    # the same queries over every 512th key (2^15 keys): all the levels
    # come from the shared tree, none from the keys but the last
    sk_top = sk[::512].contiguous()
    tree_only_ms = timed_ms(lambda: kernel.sorted_search_kernel(sk_top, q))
    n_q = len(queries)
    touched, rank = _search_probes(sk_np, queries)
    path_sectors = _sectors(touched, 4)
    # the function's bytes: queries in, ranks out, and the sectors of each
    # query's bracket keys (the keys that fix its rank)
    sectors = _sectors(_bracket(rank, len(sk_np)), 4)
    hit_at = (rank - 1)[(rank > 0) & (sk_np[np.maximum(rank - 1, 0)]
                                      == queries)]
    value_sectors = _sectors(hit_at, 4)
    n_bytes = 4 * n_q + 4 * n_q + 32 * sectors
    # the Get: queries in, found (1 byte) and values out, the bracket key
    # sectors and the value sectors of the hits
    get_bytes = 4 * n_q + n_q + 4 * n_q + 32 * (sectors + value_sectors)
    n_ops = n_q * math.ceil(math.log2(len(keys)))
    return _row("K1 sorted_search", "cuda",
                "src/repro_torch/csrc/sorted_search.cu",
                "src/repro/kernels/sorted_search/kernel.py:45 "
                "(sorted_search_kernel, _search_kernel :31)",
                launches.get("sorted_search", 0), 0.0, times["ms"],
                times["plain_ms"], n_bytes, n_ops, "int32",
                times["library_ms"],
                {"shape": f"N={len(keys)} Q={n_q}", "cases": n_cases,
                 "top_levels": kernel.top_levels(len(keys)),
                 "bracket_key_sectors": sectors,
                 "search_path_keys": int(len(touched)),
                 "search_path_key_sectors": path_sectors,
                 "search_path_bound_ms": (4 * n_q + 4 * n_q +
                                          32 * path_sectors) /
                 HBM_BYTES_PER_S * 1e3,
                 "value_sectors_of_hits": value_sectors,
                 "sorted_get_ms": times["sorted_get_ms"],
                 "sorted_get_plain_ms": times["sorted_get_plain_ms"],
                 "sorted_get_bytes": get_bytes,
                 "traced_ms": traced,
                 "tree_only_ms": tree_only_ms,
                 "sorted_get_bound_ms": max(
                     get_bytes / HBM_BYTES_PER_S * 1e3,
                     n_ops / INT32_OPS_PER_S * 1e3)})


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
                          (10, 8, 9000, 4097), (5, 33, 700, 333),
                          (1, 32, 40, 45), (4, 16, 900, 101)):
        k = rng.choice(1 << 20, n, replace=False)
        t_k, t_v = ref.build_table(k, k * 3 + 1, s, DEFAULT_A, cap)
        qq = np.concatenate([k[: nq // 2], rng.integers(1 << 21, 1 << 22,
                                                        nq - nq // 2)])
        qq[0] = ref.EMPTY_KEY          # the reference's empty-slot match
        cases.append((torch.as_tensor(t_k, device=DEVICE),
                      torch.as_tensor(t_v, device=DEVICE),
                      torch.as_tensor(qq.astype(np.int32), device=DEVICE),
                      s))
    # the main table 4 bytes off 16-byte alignment: the scalar loads
    buf = torch.zeros(tk.size + 1, dtype=torch.int32, device=DEVICE)
    buf[1:] = main[0].reshape(-1)
    cases.append((buf[1:].view(tk.shape),) + main[1:])
    mismatches = 0
    for t_k, t_v, qq, s in cases:
        p1, v1 = kernel.hash_probe_kernel(t_k, t_v, qq, DEFAULT_A, s)
        p2, v2 = ref.hash_probe_ref(t_k, t_v, qq, DEFAULT_A, s)
        mismatches += int((p1 != p2).sum()) + int((v1 != v2).sum())
    assert mismatches == 0, f"K3 vs plain: {mismatches} mismatches"
    t_k, t_v, qq, s = main
    ms = timed_ms(lambda: kernel.hash_probe_kernel(t_k, t_v, qq, DEFAULT_A,
                                                   s))
    scalar_ms = timed_ms(lambda: kernel.hash_probe_kernel(
        cases[-1][0], t_v, qq, DEFAULT_A, s))
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
                n_q * 2 * HASH_CAP, "int32", None,
                {"shape": f"table=[2^{HASH_S},{HASH_CAP}] Q={n_q}",
                 "unaligned_table_scalar_loads_ms": scalar_ms})


def kernel_k2(data, rng, launches) -> dict:
    import torch
    from repro_torch.kernels.scan_filter import kernel, ref
    lg = data["log"]
    keys = torch.as_tensor(lg["keys"], device=DEVICE)
    passed = torch.as_tensor(lg["queries"][lg["maybe"]], device=DEVICE)
    main = (keys, passed, passed, passed)        # scan_get's call
    cases = [main]
    for n, q, dtype in ((1500, 100, np.int32), (300_001, 4097, np.int32),
                        (128, 770, np.float32), (100_003, 999, np.float32)):
        k = rng.integers(0, 1 << 16, n).astype(dtype)
        qq = rng.integers(0, 1 << 16, q).astype(dtype)
        qq[: q // 2] = k[rng.integers(0, n, q // 2)]
        if dtype == np.int32:
            k[-1] = qq[-1] = 2147483647     # a real int32-max key
        cases.append(tuple(torch.as_tensor(a, device=DEVICE)
                           for a in (k, qq, qq - 64, qq + 64)))
    mismatches = 0
    for args in cases:
        p1, c1 = kernel.scan_filter_kernel(*args)
        p2, c2 = ref.scan_filter_ref(*args)
        mismatches += int((p1 != p2).sum()) + int((c1 != c2).sum())
    assert mismatches == 0, f"K2 vs plain: {mismatches} mismatches"
    ms = timed_ms(lambda: kernel.scan_filter_kernel(*main), reps=10)
    plain_ms = timed_ms(lambda: ref.scan_filter_ref(*main), reps=2,
                        warmup=1)
    n, q = keys.shape[0], passed.shape[0]
    n_bytes = 4 * n + 3 * 4 * q + 2 * 4 * q
    return _row("K2 scan_filter", "cuda", "src/repro_torch/csrc/scan_filter.cu",
                "src/repro/kernels/scan_filter/kernel.py:55 "
                "(scan_filter_kernel, _scan_kernel :30)",
                launches.get("scan_filter", 0), 0.0, ms, plain_ms, n_bytes,
                n * q * K2_OPS_PER_PAIR, "int32", None,
                {"shape": f"N={n} Q={q} (the queries the filter passed)",
                 "pairs_per_s": n * q / (ms * 1e-3)})


def k4_op_times(w_t, lq_t) -> dict:
    """The log path's membership probe (ops.bloom_probe at the kvstore
    shape): its device time back to back, its host time per call (host
    clock over 100 calls, then one synchronise), and the device kernels
    one call launched, from a trace (the same calls in this and older
    trees)."""
    import torch
    from repro_torch.kernels.bloom_probe.ops import bloom_probe

    def op():
        return bloom_probe(w_t, lq_t, s=BLOOM_S, num_hashes=BLOOM_K)

    device_ms = timed_ms(op)
    for _ in range(10):
        op()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        op()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    # 10 calls traced: a lone 3-microsecond kernel can miss a trace of one
    trace = _profile(op, 10)
    return {"op_ms": device_ms, "op_host_us_per_call": host_us,
            "op_device_kernels": trace["device_events_per_step"],
            "op_kernel_names": list(trace["top_kernels_ms_per_step"]),
            "op_traced_device_ms": trace["device_ms_per_step"]}


def kernel_k4(data, rng, launches) -> dict:
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.bloom_probe import kernel, ref
    from repro_torch.kernels.bloom_probe.ops import DEFAULT_COEFFS
    lg = data["log"]
    coeffs = DEFAULT_COEFFS[:BLOOM_K]
    main = (torch.as_tensor(lg["words"].view(np.int32), device=DEVICE),
            torch.as_tensor(lg["queries"], device=DEVICE), coeffs, BLOOM_S)
    cases = [main]
    for s, k, q in ((13, 1, 1000), (16, 4, 4097), (5, 2, 7), (20, 5, 33)):
        keys = rng.choice(1 << 24, 2000, replace=False)
        words = ref.build_filter(keys, DEFAULT_COEFFS[:k], s)
        qq = np.concatenate([keys[: q // 2], rng.integers(
            -2**31, 2**31, q - q // 2)]).astype(np.int32)[:q]
        cases.append((torch.as_tensor(words.view(np.int32), device=DEVICE),
                      torch.as_tensor(qq, device=DEVICE), DEFAULT_COEFFS[:k],
                      s))
    mismatches = 0
    for args in cases:
        mismatches += int((kernel.bloom_probe_kernel(*args)
                           != ref.bloom_hits_ref(*args)).sum())
        mismatches += int((kernel.bloom_probe_kernel(*args, mask=True)
                           != ref.bloom_probe_ref(*args)).sum())
    assert mismatches == 0, f"K4 vs plain: {mismatches} mismatches"
    ms = timed_ms(lambda: kernel.bloom_probe_kernel(*main, mask=True))
    hits_ms = timed_ms(lambda: kernel.bloom_probe_kernel(*main))
    plain_ms = timed_ms(lambda: ref.bloom_probe_ref(*main))
    hits_plain_ms = timed_ms(lambda: ref.bloom_hits_ref(*main))
    before = launch_counts()
    op = k4_op_times(main[0], main[1])
    after = launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    # every op call is one launch of the mask variant (counters), and the
    # trace holds that kernel and no other, at most once a call
    calls = moved.get("bloom_probe_mask", 0)
    assert moved == {"bloom_probe_mask": calls} and calls > 0, moved
    names = op["op_kernel_names"]
    assert len(names) == 1 and "bloom_kernel<true>" in names[0] and \
        0 < op["op_device_kernels"] <= 1, \
        f"a bloom_probe op call ran {op['op_device_kernels']} device " \
        f"kernels: {names}"
    from repro_torch.kernels.bloom_probe.ref import _hashes
    hv = _hashes(lg["queries"], coeffs, BLOOM_S)
    sectors = len(np.unique(hv >> 8))           # 32-byte sectors touched
    n_q = len(lg["queries"])
    # the mask variant (the path's): queries in, one byte a query out
    n_bytes = 32 * sectors + 4 * n_q + n_q
    hits_bytes = 32 * sectors + 4 * n_q + 4 * n_q * BLOOM_K
    # per (query, hash): multiply, shift, word index, bit test
    n_ops = 4 * n_q * BLOOM_K
    return _row("K4 bloom_probe", "cuda", "src/repro_torch/csrc/bloom_probe.cu",
                "src/repro/kernels/bloom_probe/kernel.py:52 "
                "(bloom_probe_kernel, _bloom_kernel :26)",
                launches.get("bloom_probe", 0) +
                launches.get("bloom_probe_mask", 0), 0.0, ms, plain_ms,
                n_bytes, n_ops, "int32", None,
                {"shape": f"filter=2^{BLOOM_S} bits k={BLOOM_K} Q={n_q}",
                 "variant": "mask",
                 "launches_by_variant": {
                     "hits": launches.get("bloom_probe", 0),
                     "mask": launches.get("bloom_probe_mask", 0)},
                 "sectors_touched": sectors, "hits_ms": hits_ms,
                 "hits_plain_ms": hits_plain_ms, "hits_bytes": hits_bytes,
                 "hits_bound_ms": max(hits_bytes / HBM_BYTES_PER_S * 1e3,
                                      n_ops / INT32_OPS_PER_S * 1e3),
                 **op})


def _causal_pairs(sq: int, skv: int) -> int:
    """(row, col) pairs a top-left-aligned causal mask keeps."""
    rows = np.arange(sq, dtype=np.int64)
    return int(np.minimum(rows + 1, skv).sum())


def _k5_inputs(gen, b, h, kh, sq, skv, d, dtype):
    """q, k, v in the model's [B, S, H, D] layout, as [B, H, S, D] views."""
    import torch
    q = torch.randn((b, sq, h, d), generator=gen, device=DEVICE).to(dtype)
    k = torch.randn((b, skv, kh, d), generator=gen, device=DEVICE).to(dtype)
    v = torch.randn((b, skv, kh, d), generator=gen, device=DEVICE).to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def kernel_k5(seed, launches) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    b, h, kh, sq, d = LM_BATCH, 12, 2, LM_PROMPT, 128
    main = _k5_inputs(gen, b, h, kh, sq, sq, d, torch.bfloat16)
    # (inputs, causal, rtol, atol): bf16 output rounding is 2^-9 relative,
    # held at 2^-8 plus 1e-4; float32 at 1e-5.  bf16 at D 64 / 128 runs
    # the tensor-core variant, the rest the SIMT one
    bf16_tol, f32_tol = (2.0 ** -8, 1e-4), (1e-5, 1e-5)
    cases = [(main, True) + bf16_tol,
             (_k5_inputs(gen, 1, h, kh, 1000, 777, d, torch.bfloat16),
              False) + bf16_tol,
             (_k5_inputs(gen, 2, h, kh, 1000, 1000, d, torch.float32),
              True) + f32_tol,
             (_k5_inputs(gen, 1, 4, 4, 200, 300, 24, torch.float32),
              False) + f32_tol,
             (_k5_inputs(gen, 2, 8, 2, 333, 333, 64, torch.bfloat16),
              True) + bf16_tol,
             (_k5_inputs(gen, 1, h, kh, 300, 200, d, torch.bfloat16),
              True) + bf16_tol]
    errs = []
    for (q, k, v), causal, rtol, atol in cases:
        kind = kernel.variant(q.dtype, q.shape[-1])
        before = launch_counts()
        got = kernel.flash_attention_kernel(q, k, v, causal).float()
        after = launch_counts()
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        err = (got - want).abs()
        errs.append(float(err.max()))
        assert bool((err <= atol + rtol * want.abs()).all()), \
            f"K5 ({kind}) vs plain {tuple(q.shape)} causal={causal}: max " \
            f"abs {errs[-1]:.3e}"
        moved = {n: after[n] - before.get(n, 0) for n in after
                 if n.startswith("flash_attention")}
        assert moved == {"flash_attention": 1,
                         f"flash_attention_{kind}": 1,
                         **{f"flash_attention_{o}": 0 for o in
                            kernel.VARIANT_LAUNCHES if o != kind}}, \
            f"K5 {tuple(q.shape)} {q.dtype}: counters moved {moved}"
    # the gradient: forward on K5, backward through attention_ref
    xs = _k5_inputs(gen, 2, 4, 2, 100, 100, 32, torch.float32)
    w = torch.randn(xs[0].shape, generator=gen, device=DEVICE)
    ga = [x.detach().clone().requires_grad_(True) for x in xs]
    (ops.flash_attention(*ga, True) * w).sum().backward()
    gb = [x.detach().clone().requires_grad_(True) for x in xs]
    (attention_ref(*gb, causal=True) * w).sum().backward()
    grad_err = max(_max_abs(x.grad, y.grad) for x, y in zip(ga, gb))
    assert grad_err <= 1e-4, f"K5 gradient vs plain: {grad_err:.3e}"

    q, k, v = main
    ms = timed_ms(lambda: kernel.flash_attention_kernel(q, k, v, True),
                  reps=20)
    plain_ms = timed_ms(lambda: attention_ref(q, k, v, causal=True),
                        reps=5)
    qc, kc, vc = (x.contiguous() for x in main)
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), reps=20)
    # the SIMT variant at the same shape in float32 (the float32-compute
    # path's kernel)
    qf, kf, vf = (x.float() for x in main)
    simt_ms = timed_ms(lambda: kernel.flash_attention_kernel(qf, kf, vf,
                                                             True), reps=5)
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    n_ops = 4 * b * h * d * _causal_pairs(sq, sq)
    return _row("K5 flash_attention", "cuda",
                "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:84 "
                "(flash_attention_kernel, _flash_kernel :33)",
                launches.get("flash_attention", 0), errs[0], ms, plain_ms,
                n_bytes, n_ops, "bf16_tensor", library_ms,
                {"shape": f"[{b},{h},{sq},{d}] kv_heads={kh} bf16 causal, "
                          f"[B,S,H,D] strides",
                 "variant": kernel.variant(q.dtype, d),
                 "launches_by_variant": {
                     kind: launches.get(f"flash_attention_{kind}", 0)
                     for kind in kernel.VARIANT_LAUNCHES},
                 "max_abs_err_cases": errs, "grad_max_abs_err": grad_err,
                 "tflops": n_ops / (ms * 1e-3) / 1e12,
                 # the tensor-core work the kernel does: P V twice (P
                 # split into bf16 hi + lo), so 1.5x the bound's count
                 "tensor_tflops_done": 1.5 * n_ops / (ms * 1e-3) / 1e12,
                 **kernel.wgmma_info(d),
                 "simt_float32_ms": simt_ms,
                 "simt_float32_shape": f"[{b},{h},{sq},{d}] float32 causal",
                 "library": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True, enable_gqa=True)"})


def only_stores(seed: int) -> dict:
    """``--only stores``: K1's times and the bloom_probe op's at the
    kvstore phase's shapes and data."""
    import torch
    from repro_torch.kernels.bloom_probe.ops import (DEFAULT_COEFFS,
                                                     build_filter,
                                                     filter_words)
    data = kv_data(seed)
    lg = data["log"]
    order = np.argsort(data["keys"])
    sk, sv = (torch.as_tensor(a[order], device=DEVICE)
              for a in (data["keys"], data["values"]))
    words = build_filter(lg["keys"], DEFAULT_COEFFS[:BLOOM_K], BLOOM_S)
    return {"k1": k1_times(sk, sv, torch.as_tensor(data["queries"],
                                                   device=DEVICE)),
            "k4": k4_op_times(filter_words(words, DEVICE),
                              torch.as_tensor(lg["queries"], device=DEVICE))}


def _row(name, route, source, replaces, launches, max_abs_err, ms,
         plain_ms, n_bytes, n_ops, ops_peak, library_ms, extra) -> dict:
    """One line of the kernels table.  The bound is the larger of the
    bytes over HBM bandwidth and the operations over the peak of their
    type (``ops_peak``, a key of PEAKS)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAKS[ops_peak] * 1e3
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max_abs_err, "ms": ms, "kernel_ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "ops_peak": ops_peak, "bytes_ms": t_bytes, "ops_ms": t_ops,
           "library_ms": library_ms, "bytes": n_bytes, "ops": n_ops}
    row.update(extra)
    return row


# ---------------------------------------------------------------------------
def _nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def _write_report(path, report) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1, default=str)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", default=None,
                        help="also write the full report as JSON here")
    parser.add_argument("--only", choices=["whatif", "stores"],
                        default=None,
                        help="whatif: run that phase alone, without the "
                             "check of its launches; stores: time K1 and "
                             "the bloom_probe op at the kvstore shapes.  "
                             "Either prints its report but no kernels line "
                             "and no result line (to time an older "
                             "checkout's src/ with this script)")
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
    names = [n for n in build.SOURCES
             if args.only != "stores" or n != "flash_attention"]
    build.build(names)
    report["nvcc_build_s"] = time.perf_counter() - t0
    for name in names:
        for line in build.build_log(name).read_text().splitlines():
            if ("registers" in line or "spill" in line or
                    "entry function" in line):
                log(f"ptxas {name}: {line.strip()}")

    if args.only == "stores":
        report["stores"] = only_stores(args.seed)
        log("stores: " + json.dumps(report["stores"]))
        _write_report(args.report, report)
        log(_nvidia_smi())
        return 0
    t0 = time.perf_counter()
    report["whatif"] = phase_whatif(args.seed, one_launch=not args.only)
    report["whatif"]["phase_s"] = time.perf_counter() - t0
    log("whatif: " + json.dumps({k: v for k, v in report["whatif"].items()
                                 if k != "best_designs"}))
    if args.only:
        _write_report(args.report, report)
        log(_nvidia_smi())
        return 0

    t0 = time.perf_counter()
    data = kv_data(args.seed)
    report["kvstore"] = phase_kvstore(data)
    report["kvstore"]["phase_s"] = time.perf_counter() - t0
    log("kvstore: " + json.dumps(report["kvstore"]))

    t0 = time.perf_counter()
    report["lm"] = phase_lm(args.seed)
    report["lm"]["phase_s"] = time.perf_counter() - t0
    lm = report["lm"]
    log(f"lm prefill: {lm['prefill_s']:.4f} s for {LM_BATCH} x {LM_PROMPT} "
        f"tokens ({lm['prefill_tok_s']:.0f} tokens/s)")
    log(f"lm decode: {lm['decode_tok_s']:.1f} tokens/s ({LM_BATCH} x "
        f"{LM_DECODE} steps in {lm['decode_s']:.4f} s)")
    log("lm: " + json.dumps(lm))

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 2)
    frontier = autocomplete.enumerate_frontier((), max_depth=DEPTH)
    workloads = [Workload(n_entries=1_000_000, n_queries=100)] * N_POINTS
    mixes = whatif.read_fraction_mixes(np.linspace(0.0, 1.0, N_POINTS))
    kernels = [
        kernel_k0(frontier, workloads, mixes, rng,
                  report["whatif"]["launches"]),
        kernel_k1(data, rng, report["kvstore"]["launches"]),
        kernel_k2(data, rng, report["kvstore"]["launches"]),
        kernel_k3(data, rng, report["kvstore"]["launches"]),
        kernel_k4(data, rng, report["kvstore"]["launches"]),
        kernel_k5(args.seed, report["lm"]["launches"]),
    ]
    report["kernels_phase_s"] = time.perf_counter() - t0
    report["total_s"] = time.perf_counter() - t_start

    smi = _nvidia_smi()
    report["nvidia_smi"] = smi
    report["kernels"] = kernels
    _write_report(args.report, report)
    log(f"total {report['total_s']:.1f}s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
