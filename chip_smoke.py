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
  (float32 compute: logits and KV cache within 5e-2, its 28 K5 launches
  all ``tf32x3``; bf16 compute: no further from the float32 logits than
  the plain path); one prefill and four decode steps are traced with
  ``torch.profiler``.
* ``families`` (last, after the search phase): every other model family at
  its published widths and depths, random weights from ``--seed``, flash
  attention, one model at a time with its peak memory: granite-moe-1b
  (4 x 2,048-token fused prefill, K5 24 times, and 32 decode steps
  through ``serve_batch``; tokens dropped by capacity, by the MoE
  layers' tallies in a traced prefill; the MoE spans' device time),
  zamba2-1.2b and xlstm-350m (forward on 4 x 2,048 tokens,
  zamba2's 7 shared-attention applications on K5; ``serve_batch`` on 4
  prompts of 64 tokens, stepped, and 16 decode steps; decode against
  forward over those positions; the scan spans' device time),
  seamless-m4t-large-v2 (encode 4 x 1,024 frames, forward on 4 x 512
  targets, ``prefill_cross`` and 16 decode steps: K5 non-causal and
  with Sq != Skv), pixtral-12b (256 patches + 1,792 tokens, x 4, through
  the fused prefill, all 40 K5 launches on its tensor-core variant at
  D 160, and 32 decode steps).  Each is held against the plain attention
  path as the lm phase is (xlstm, without attention: float32 on the card
  against the host's CPU), every K5 launch of the float32 flash run on
  ``tf32x3``; every check runs before the phase fails on any.
* ``kernels``: every kernel against its plain PyTorch version on the
  card, at the phases' shapes plus ragged ones, with times and bounds;
  K1 also at its edges (N around its shared tree's size, N = 1-33, runs of
  duplicates, the dtype's extremes, unaligned keys, 2^20 queries) with
  its bound in 32-byte sectors of the keys that fix each rank (the search
  path's sectors beside it), the Get's time and bound and the tree
  depth, NaN queries among the float32 cases; K4's hits and mask
  variants, and the bloom_probe op's device time, host time per call and
  the kernels one call launched (traced); K5 also at each family's
  attention shapes, with SDPA's time beside it, and the registers and
  shared memory of its tensor-core variant at each head dim it is built
  for; K5's float32 forward (its own row, ``tf32x3``: 3xTF32 on the
  tensor cores) at qwen2-1.5b's shape and every family's in float32,
  beside the plain version, SDPA in float32 and both bounds, with its
  registers, shared memory and spills and its launches on every float32
  path (the lm and families phases' float32 flash witnesses, the train
  phase's float32 first step); K5's
  backward (two rows: ``wgmma`` in bf16 and ``tf32x3`` in float32, at
  the train shape; also at each family's shape): one launch of its
  variant, two calls bit-equal, against the float32 pullback (bf16: each
  gradient's rms distance at most 1.25x SDPA backward's; float32: 1e-4
  relative rms, SDPA's recorded beside it), timed beside the plain
  version and SDPA's backward, at the train shape each of a call's
  kernels traced, with both variants' registers and shared memory; the
  MoE combine (its own row) at the granite prefill cell's 4,096- and
  512-token batches, bf16, under plain and skewed routing: against its
  plain version (one bf16 rounding of the float32 sum), two calls
  bit-equal, timed beside the plain version and the ``index_add_``
  scatter it replaced, its bytes bound, one call traced by kernel, and
  its launches on the granite family's ``serve_batch`` (one a layer in
  the prefill and each decode step, checked).
* ``search``: a profile trained at the full grid (the 14 Level-2
  micro-benchmarks on the host, ``repro_torch.core.training.
  train_profile``, every fit on the card), every step of every fit
  replayed on the CPU from the card's record (``models.replay_gap``) and
  each final fit's gap from the same fit on the CPU recorded, saved and
  reloaded; on ``hw3`` and on
  that profile the reference's population-search configuration
  (``benchmarks/popsearch_bench.py``: budget 256, population 16, seed
  10) run twice — the same winner and cost, no new K0 specialisation —
  beside beam search under the same budget; a search over the whatif
  phase's 64 read-fraction points and a two-region hybrid; every winner
  against the scalar oracle (1e-6 relative) and K0's launches counted;
  the fitters' launches per Adam step and the surrogate's per call.
* ``serving`` (after the kernels phase): ``repro_torch.serving.
  DesignCalculatorService`` at ``benchmarks/serving_bench.py``'s full
  size — 96 mixed what-if questions (design, hardware, workload; an
  auto-completion at ``max_depth=2`` every 8th) on ``hw1``-``hw3`` over
  ``Workload(1_000_000, 100)``, its ``zipf_alpha=1.5`` and 4x-grown
  variants, ``window_s=0.25``, ``max_batch=96``: the serial one-call loop
  against the same questions submitted together (every answer within
  1e-6 of the serial one and of the scalar oracle, from the fused
  engine), a hardware-swap burst against a freshly registered profile
  (no new K0 specialisation), questions/s, p50/p99 latency, K0 launches
  a window and a trace of one window; the whatif phase's sweep through
  ``submit_sweep`` on one slot (one K0 launch) and on two slots of
  ``cuda:0`` (two launches), both bit for bit the direct sweep; the
  popsearch configuration through ``submit_search`` (the direct run's
  winner and cost); a corrupt fused total healed inside the pool and
  corrupt banks served by the grouped oracle until the recovery probe.
* ``train`` (last): qwen2-1.5b at its published widths and depth (float32
  parameters, bf16 compute, remat, flash attention) trained 8 steps of 4 x
  2,048 tokens through ``repro_torch.launch.train.train``, a checkpoint
  every 4 steps into a temporary directory, then resumed from the step-4
  checkpoint to step 8 (the resumed losses bit for bit the uninterrupted
  run's).  Before the run, its first step on the same state and batch
  against the plain attention path (float32 compute: loss and grad_norm
  within 1e-4 relative; bf16: the gradient no further, by rms, from the
  float32 plain gradient than 1.25x the bf16 plain path's), and one step
  counted and traced (K5 56 times, forward and remat recompute, and its
  backward 28 times, every launch its tensor-core variant; the trace
  holds the backward's kernels a launch, four where its dK/dV pass is
  split; the float32 first step's 56 forward and 28 backward launches
  all tf32x3).
  Records the step's
  host seconds
  (median of steps 2-8), tokens/s, device ms, launches, K5's share, the
  card's busy share, the step's share of the bf16 peak and peak memory.
* ``distcalc`` (after train, from the run's own measurements):
  ``repro_torch.core.distcalc`` on ``H100_SXM`` and a one-chip
  ``MeshSpec(1, 1, 1)`` predicts every cell the run measured (the train
  step with its own strategy, the lm prefill and decode step, each
  family's prefill or forward and decode step): the three roofline terms,
  the dominant one, the measured seconds and their ratio on a line each;
  then the train cell's what-if, ``complete_strategy``'s remat-off
  strategy run on the card for WHATIF_STEPS steps (no checkpoints): its
  step seconds, peak memory, K5's launches (28 a step and 28 backward,
  all ``wgmma``) and
  whether the card orders the two strategies as predicted.  Checks: every
  prediction finite and positive with ``step_seconds`` its largest term,
  the chosen strategy valid and fitting, ``fits_memory`` false for the
  three configs one card cannot hold and true for the six it runs.
* ``dryrun`` (after distcalc): ``repro_torch.launch.dryrun``'s per-chip
  counter on the card.  Every cell the run measured counted on one
  card's fake CUDA tensors at the shapes and with the flash attention it
  ran (FLOPs, bytes, collective bytes; K5 and its backward by their ops'
  flop formulas, the train step's remat recompute included)
  beside distcalc's predicted FLOPs and terms on ``H100_SXM``, the H100
  roofline of the count and the measured seconds; one real qwen2-1.5b
  train step counted under the same counter, its FLOPs the fake count's
  exactly, K5 56 launches and its backward 28; then phi3.5-moe-42b,
  qwen1.5-32b and
  llama3-405b at ``train_4k`` on the (16, 16) fake mesh with probes, and
  phi3.5-moe-42b on (2, 16, 16), each through ``python -m
  repro_torch.launch.dryrun`` in a subprocess on meta tensors, all at
  once: the count's
  seconds, per-chip counts and memory, the H100_SXM and TPU_V5E roofline
  terms, distcalc's and ``useful_flops_ratio`` on a line each.  A failed
  subprocess fails the phase.

Launch counters are reset just before each path and read just after it.
Prints the card's name and power limit, one JSON line with the kernels,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is absent or any check fails.
``--only whatif`` runs the whatif phase alone, ``--only stores`` times
K1 and the bloom_probe op at the kvstore shapes, ``--only k5`` times K5
and its backward beside SDPA at the lm and train shapes and each
family's, ``--only moe_combine`` times the MoE combine's cases,
``--only train``
runs the train phase alone and ``--only dryrun`` the dryrun phase (no
measured times); they print no result line.
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

from repro_torch.core.hardware import H100_SXM  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and bf16 dense tensor
#: cores from ``H100_SXM`` (the profile distcalc predicts with, so the
#: kernel bounds and the predictions share one source), float32
#: (non-tensor); INT32 throughput from the Hopper white paper: 64 INT32
#: lanes per SM x 132 SMs x the 1.98 GHz boost clock
HBM_BYTES_PER_S = H100_SXM.hbm_bw
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = H100_SXM.peak_flops_bf16
INT32_OPS_PER_S = 64 * 132 * 1.98e9
#: dense TF32 tensor cores (NVIDIA data sheet): the tf32x3 backward runs
#: three tf32 products for each float32 one
TF32_TC_OPS_PER_S = 495e12
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
# search: train the Level-2 cost models on the card, then search for designs
# ---------------------------------------------------------------------------
#: the reference's population-search configuration
#: (benchmarks/popsearch_bench.py, not its smoke variant)
SEARCH_BUDGET = 256
SEARCH_KW = {"population": 16, "generations": 200, "refine_top": 2,
             "refine_steps": 2, "seed": 10}
BEAM_WIDTH, BEAM_ROUNDS = 8, 64
#: fitted predictions, card against CPU, as a share of max |y|: the
#: tolerance tests/test_torch_fit.py states and justifies (recorded
#: here: on fresh host timings the fits drift past it, see
#: REPLAY_GRAD_TOL)
FIT_ATOL = 5e-3
#: every Adam step of a card fit replayed on the CPU from the card's
#: record (models.replay_gap): the gradient at the card's parameters
#: over the fit's largest gradient entry (CPU fits of data one float32
#: ulp apart, replayed against each other: up to 6.7e-6; a wrong
#: gradient is off by its own size), and the update from the card's
#: state and gradient over its terms' size (a few float32 ulps; a wrong
#: moment, bias correction or projection is off by 1e-3 or more)
REPLAY_GRAD_TOL, REPLAY_UPDATE_TOL = 1e-4, 1e-5
ORACLE_RTOL = 1e-6
#: the fitters' two families, by model kind
FAMILIES = {"linear": "linear_basis", "log_linear": "linear_basis",
            "log_loglog": "linear_basis", "nlogn": "linear_basis",
            "sigmoids": "sigmoids"}


def _per_step(fn_of_steps, short: int = 10, long: int = 50) -> dict:
    """Launches and times per loop step of ``fn_of_steps(steps)`` on the
    card: one call traced at ``short`` and one at ``long`` steps,
    differenced, so what the two calls share (set-up, copies) cancels.
    Also the short call's own launches (the set-up plus ``short``
    steps)."""
    a = _profile(lambda: fn_of_steps(short), 1)
    b = _profile(lambda: fn_of_steps(long), 1)
    span = long - short
    out = {k: (b[k] - a[k]) / span for k in (
        "launches_per_step", "device_events_per_step",
        "device_ms_per_step", "wall_ms_per_step")}
    out["setup_launches"] = a["launches_per_step"] - \
        short * out["launches_per_step"]
    return out


def fit_step_profiles() -> dict:
    """Each fitter's launches and time per Adam step on the card (the
    reference's ``_fit_nnls`` and ``_fit_sigmoids_gd`` scans), and per
    whole fit at the reference's step counts (2,000 and 4,000)."""
    import torch
    from repro_torch.core import models
    x = torch.logspace(2, 8, 40, device=DEVICE)
    y = 2e-9 * x + 4e-8 * torch.log(x + 1.0) + 1e-7
    logx = torch.log(x + 1.0)
    init = {k: torch.as_tensor(v, device=DEVICE) for k, v in
            models._sigmoid_init(logx.cpu().numpy(), y.cpu().numpy(),
                                 3).items()}
    out = {"nnls": _per_step(
        lambda n: models._fit_nnls(x, y, "log_loglog", steps=n)),
        "sigmoids": _per_step(
        lambda n: models._fit_sigmoids_gd(logx, y, init, steps=n))}
    for name, steps in (("nnls", 2000), ("sigmoids", 4000)):
        per = out[name]
        per["steps_per_fit"] = steps
        per["launches_per_fit"] = per["setup_launches"] + \
            steps * per["launches_per_step"]
    return out


def surrogate_profiles(hw) -> dict:
    """The relaxed surrogate's value and gradient (the reference's jitted
    ``_surrogate_fn``), one call per template: launches, device and host
    time per call on the card."""
    import torch
    from repro_torch.core import devicecost, relax, search
    table = devicecost.device_table(hw)
    args = [torch.tensor(v, dtype=torch.float32, device=DEVICE)
            for v in (1e6, 0.8, 8.0)]
    out = {}
    for template in (search.DEFAULT_TEMPLATES[0],
                     search.DEFAULT_TEMPLATES[6]):
        fn = relax._surrogate_fn(template)
        lo, hi = template.knob_bounds()
        theta = torch.tensor(0.5 * (lo + hi), dtype=torch.float32,
                             device=DEVICE)
        fn(theta, table.banks, *args)
        prof = _profile(lambda: fn(theta, table.banks, *args), 20)
        out[template.describe()] = {
            "launches_per_call": prof["launches_per_step"],
            "device_events_per_call": prof["device_events_per_step"],
            "device_ms_per_call": prof["device_ms_per_step"],
            "wall_ms_per_call": prof["wall_ms_per_step"]}
    return out


def _oracle_rel(cost: float, oracle: float) -> float:
    return abs(cost - oracle) / abs(oracle)


def _starts():
    from repro_torch.core import elements as el
    return [el.spec_btree(), el.spec_trie(), el.spec_csb_tree()]


def popsearch(label: str, hw, workload, mix) -> dict:
    """The reference's population-search benchmark on one profile: beam
    search under the same designs budget, then the population search
    twice (a warm-up, then the measured run: the same winner and cost,
    no new K0 specialisation), the winner against the scalar oracle."""
    from repro_torch.core import autocomplete, devicecost, search
    from repro_torch.core.synthesis import cost_workload
    from repro_torch.kernels import launch_counts
    beam_budget = search.SearchBudget(SEARCH_BUDGET)
    t0 = time.perf_counter()
    beam = autocomplete.design_beam(workload, hw, mix, start=_starts(),
                                    beam_width=BEAM_WIDTH,
                                    max_rounds=BEAM_ROUNDS,
                                    budget=beam_budget)
    beam_s = time.perf_counter() - t0

    def run():
        return search.population_search(
            workload, hw, mix, budget=search.SearchBudget(SEARCH_BUDGET),
            seeds=_starts(), **SEARCH_KW)

    t0 = time.perf_counter()
    warm = run()
    warm_s = time.perf_counter() - t0
    specs_before = devicecost.specialisation_count()
    k0_before = launch_counts().get("bank_score", 0)
    t0 = time.perf_counter()
    pop = run()
    pop_s = time.perf_counter() - t0
    k0 = launch_counts().get("bank_score", 0) - k0_before
    new_specs = devicecost.specialisation_count() - specs_before
    oracle = cost_workload(pop["design"], workload, hw, mix)
    rel = _oracle_rel(pop["cost_s"], oracle)
    assert pop["design"].chain == warm["design"].chain and \
        pop["cost_s"] == warm["cost_s"], f"{label}: search not deterministic"
    assert new_specs == 0, f"{label}: {new_specs} new K0 specialisations"
    assert rel <= ORACLE_RTOL, f"{label}: winner vs oracle {rel:.3e}"
    assert pop["oracle_cost_s"] is not None
    assert pop["designs_costed"] <= SEARCH_BUDGET
    assert beam_budget.spent <= SEARCH_BUDGET
    assert k0 >= 1, f"{label}: the search launched no K0"
    return {"design": pop["design"].describe(), "template": pop["template"],
            "cost_s": pop["cost_s"], "oracle_cost_s": oracle,
            "oracle_rel_err": rel, "designs_costed": pop["designs_costed"],
            "generations": pop["generations"], "search_s": pop_s,
            "warmup_s": warm_s, "refine_s": pop["refine_s"],
            "designs_per_s": pop["designs_costed"] / pop_s,
            "k0_launches": k0, "new_k0_specialisations": new_specs,
            "beam_design": beam["design"], "beam_cost_s": beam["cost_s"],
            "beam_designs_costed": beam["designs_costed"],
            "beam_rounds": beam["rounds"], "beam_s": beam_s,
            "beam_designs_per_s": beam["designs_costed"] / beam_s,
            "pop_over_beam_cost": pop["cost_s"] / beam["cost_s"]}


def phase_search(seed: int) -> dict:
    """Train a profile at the full grid (measurements on the host, fits
    on the card), replay every fit's steps on the CPU, save
    and reload it, then run the reference's population-search
    configuration on hw3 and on that profile, a 64-point search and a
    two-region hybrid, every winner against the scalar oracle."""
    import dataclasses
    from repro_torch.core import (access, autocomplete, hardware, models,
                                  search, training, whatif)
    from repro_torch.core.hardware import HardwareProfile
    from repro_torch.core.synthesis import Workload, cost_workload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out = {}
    reset_launch_counts()
    t_path = time.perf_counter()
    measured, records = {}, {}
    trained = training.train_profile("HW-card-host", measurements=measured,
                                     records=records)
    c = trained.constants
    out["training_s"] = c["training_seconds"]
    out["measure_s"] = c["training_seconds"] - c["fitting_seconds"]
    out["fit_s"] = c["fitting_seconds"]
    fit_s = {}
    for pname, prim in access.LEVEL2.items():
        family = FAMILIES[prim.model_kind]
        fit_s[family] = fit_s.get(family, 0.0) + c[f"fit_seconds_{pname}"]
    out["fit_s_by_family"] = fit_s
    out["r2"] = {p: c[f"r2_{p}"] for p in access.LEVEL2}
    out["grid_sizes"] = {p: len(x) for p, (x, _) in measured.items()}
    assert all(np.isfinite(v) for v in out["r2"].values())

    # every step of every card fit replayed on the CPU from the card's
    # record: gradients within REPLAY_GRAD_TOL, updates REPLAY_UPDATE_TOL
    t0 = time.perf_counter()
    replay = {p: models.replay_gap(r, "cpu") for p, r in records.items()
              if r}
    out["replay_s"] = time.perf_counter() - t0
    out["card_replay_on_cpu"] = replay
    out["card_replay_on_cpu_max"] = {
        k: max(r[k] for r in replay.values()) for k in ("grad", "update")}
    assert out["card_replay_on_cpu_max"]["grad"] <= REPLAY_GRAD_TOL and \
        out["card_replay_on_cpu_max"]["update"] <= REPLAY_UPDATE_TOL, \
        f"card fit steps replayed on the CPU: {replay}"
    # the same (x, y) fitted on the CPU from the start, recorded: the
    # two fits drift apart by as much as two CPU fits of data one ulp
    # apart (scripts/fit_spread.py), past FIT_ATOL in some runs
    t0 = time.perf_counter()
    worst = {}
    for pname, (x, y) in measured.items():
        on_cpu = models.fit(access.LEVEL2[pname].model_kind, x, y,
                            device="cpu")
        on_card = trained.models[pname]
        assert on_card.kind == on_cpu.kind
        assert on_card.x_range == on_cpu.x_range
        scale = float(np.max(np.abs(y.astype(np.float32))))
        worst[pname] = float(np.max(np.abs(
            on_card.predict(x, "cpu") - on_cpu.predict(x, "cpu")))) / scale
    out["cpu_refit_s"] = time.perf_counter() - t0
    out["card_vs_cpu_fit"] = worst
    out["card_vs_cpu_fit_max"] = max(worst.values())
    out["card_vs_cpu_fit_over_atol"] = sorted(
        p for p, w in worst.items() if w > FIT_ATOL)

    path = os.path.join(ROOT, "build", "profiles", "card_host.json")
    trained.save(path)
    profile = HardwareProfile.load(path)
    for pname, (x, _) in measured.items():
        np.testing.assert_allclose(profile.models[pname].predict(x),
                                   trained.models[pname].predict(x),
                                   rtol=1e-6)

    workload = Workload(n_entries=1_000_000, n_queries=100)
    mix = {"get": 80.0, "update": 20.0}
    hw3 = hardware.hw3()
    out["popsearch_hw3"] = popsearch("hw3", hw3, workload, mix)
    out["popsearch_trained"] = popsearch("trained", profile, workload, mix)

    # a 64-point read-fraction axis: each generation's fresh designs at
    # every point in one K0 launch
    workloads = [workload] * N_POINTS
    mixes = whatif.read_fraction_mixes(np.linspace(0.0, 1.0, N_POINTS))
    k0_before = launch_counts().get("bank_score", 0)
    t0 = time.perf_counter()
    multi = search.population_search(
        workload, hw3, budget=search.SearchBudget(SEARCH_BUDGET),
        workloads=workloads, mixes=mixes, seeds=_starts(), **SEARCH_KW)
    multi_s = time.perf_counter() - t0
    k0 = launch_counts().get("bank_score", 0) - k0_before
    oracle = float(np.mean([cost_workload(multi["design"], w, hw3, m)
                            for w, m in zip(workloads, mixes)]))
    rel = _oracle_rel(multi["cost_s"], oracle)
    assert rel <= ORACLE_RTOL, f"64-point winner vs oracle {rel:.3e}"
    assert 1 <= k0 <= multi["generations"], \
        f"{k0} K0 launches for {multi['generations']} generations"
    out["multipoint"] = {
        "points": N_POINTS, "design": multi["design"].describe(),
        "cost_s": multi["cost_s"], "oracle_rel_err": rel,
        "designs_costed": multi["designs_costed"],
        "generations": multi["generations"], "k0_launches": k0,
        "search_s": multi_s, "refine_s": multi["refine_s"],
        "designs_per_s": multi["designs_costed"] / multi_s}

    regions = [autocomplete.DomainRegion("reads", 0.2, {"get": 100.0}),
               autocomplete.DomainRegion("writes", 0.8,
                                         {"bulk_load": 1.0,
                                          "update": 100.0})]
    hybrid = autocomplete.design_hybrid(workload, regions, hw3)
    hybrid_rel = {}
    for region, result in hybrid.regions:
        sub = dataclasses.replace(workload, n_entries=max(
            int(workload.n_entries * region.fraction), 1))
        hybrid_rel[region.name] = _oracle_rel(
            result.cost_seconds,
            cost_workload(result.spec, sub, hw3, region.mix))
    assert max(hybrid_rel.values()) <= ORACLE_RTOL, hybrid_rel
    out["hybrid"] = {"design": hybrid.describe(),
                     "cost_s": hybrid.cost_seconds,
                     "elapsed_s": hybrid.elapsed_seconds,
                     "oracle_rel_err": hybrid_rel}
    out["path_s"] = time.perf_counter() - t_path
    out["launches"] = launch_counts()
    assert out["launches"].get("bank_score", 0) > 0, "K0 never launched"

    # the fitters and the surrogate on the card, per step and per call
    out["fit_steps"] = fit_step_profiles()
    out["surrogate"] = surrogate_profiles(hw3)
    return out


# ---------------------------------------------------------------------------
# serving: design questions answered concurrently by the service
# ---------------------------------------------------------------------------
#: benchmarks/serving_bench.py at full size: 96 mixed questions, an
#: auto-completion (max_depth 2) every 8th, one window of 0.25 s
SERVE_QUESTIONS = 96
SERVE_DEPTH = 2
SERVE_WINDOW_S = 0.25
SERVE_REPS = 5
#: the reference's serving bar (coalesced over serial questions/s); the
#: phase records its ratio and does not gate on it
SERVE_TARGET = 3.0


def _mixed_questions(workload, skewed, grown, h1, h2, h3):
    """serving_bench's deterministic question list: (kind, args...)."""
    from repro_torch.core import elements as el, whatif
    specs = [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list(),
             el.spec_btree(fanout=40), el.spec_trie()]
    variants = [whatif.add_bloom_filters(el.spec_hash_table()),
                el.spec_csb_tree(), el.spec_btree(page=512)]
    qs = []
    i = 0
    while len(qs) < SERVE_QUESTIONS:
        spec = specs[i % len(specs)]
        kind = (i % 8) % 3 if i % 8 != 7 else 3
        if kind == 0:
            qs.append(("design", spec, variants[i % len(variants)],
                       workload, h1))
        elif kind == 1:
            qs.append(("hardware", spec, workload, h1, (h2, h3)[i % 2]))
        elif kind == 2:
            qs.append(("workload", spec, workload,
                       (skewed, grown)[i % 2], (h1, h2)[i % 2]))
        else:
            qs.append(("complete", (spec.chain[0],), workload,
                       (h1, h3)[i % 2], SERVE_DEPTH))
        i += 1
    return qs


def _ask_serial(q, engine: str = "fused"):
    from repro_torch.core import autocomplete, whatif
    if q[0] == "complete":
        return autocomplete.complete_design(q[1], q[2], q[3],
                                            max_depth=q[4])
    fn = {"design": whatif.what_if_design,
          "hardware": whatif.what_if_hardware,
          "workload": whatif.what_if_workload}[q[0]]
    return fn(*q[1:], engine=engine)


def _submit(svc, q):
    if q[0] == "complete":
        return svc.submit_complete(q[1], q[2], q[3], max_depth=q[4])
    return getattr(svc, f"submit_{q[0]}")(*q[1:])


def _ask_coalesced(svc, questions, latencies=None):
    """The questions submitted together; each one's seconds from submit
    to answer go into ``latencies``."""
    t0 = time.perf_counter()
    futures = [_submit(svc, q) for q in questions]
    if latencies is not None:
        for f in futures:
            f.add_done_callback(
                lambda _f: latencies.append(time.perf_counter() - t0))
    return [f.result(timeout=300) for f in futures]


def _check_answers(questions, got, serial, oracles) -> float:
    """Coalesced answers against the serial ones and the scalar oracle
    (1e-6 relative, same verdict); auto-completions against the serial
    completion (equal cost, equal designs explored).  Every answer came
    from the fused engine."""
    worst = 0.0
    for q, g, s, o in zip(questions, got, serial, oracles):
        assert g.engine == "fused", f"{q[0]} answered by {g.engine}"
        if q[0] == "complete":
            assert g.cost_seconds == s.cost_seconds, (q, g, s)
            assert g.explored == s.explored, (q, g, s)
            continue
        for attr in ("baseline_seconds", "variant_seconds"):
            c, r, want = (getattr(x, attr) for x in (g, s, o))
            for have in (c, r):
                worst = max(worst, _oracle_rel(have, want))
        assert g.beneficial == s.beneficial == o.beneficial, q
    assert worst <= ORACLE_RTOL, f"served vs oracle: {worst:.3e}"
    return worst


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def phase_serving(seed: int) -> dict:
    """serving_bench's mixed burst through the service (serial loop
    against one coalesced window, parity, the hardware-swap burst, a
    trace of one window), the whatif phase's design-continuum question
    through ``submit_sweep`` on one slot and on two slots of one card,
    the popsearch configuration through ``submit_search``, and the
    pool's healing of a corrupt fused total and of corrupt banks."""
    import dataclasses
    from repro_torch.core import devicecost, hardware
    from repro_torch.core.synthesis import Workload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import DesignCalculatorService
    del seed   # the questions are fixed; the profiles are analytical
    out = {}
    reset_launch_counts()
    t_path = time.perf_counter()
    workload = Workload(n_entries=1_000_000, n_queries=100)
    skewed = dataclasses.replace(workload, zipf_alpha=1.5)
    grown = dataclasses.replace(workload,
                                n_entries=workload.n_entries * 4)
    h1, h2, h3 = hardware.hw1(), hardware.hw2(), hardware.hw3()
    questions = _mixed_questions(workload, skewed, grown, h1, h2, h3)
    serial = [_ask_serial(q) for q in questions]        # warm the caches
    oracles = [None if q[0] == "complete" else _ask_serial(q, "scalar")
               for q in questions]
    asked = 0
    svc = DesignCalculatorService([h1, h2, h3], window_s=SERVE_WINDOW_S,
                                  max_batch=SERVE_QUESTIONS)
    try:
        got = _ask_coalesced(svc, questions)
        asked += len(questions)
        out["max_rel_vs_oracle"] = _check_answers(questions, got, serial,
                                                  oracles)
        # a hardware-swap burst, then the same against a profile
        # registered afterwards: its banks are new, K0's widths are not
        specs = sorted({q[1] for q in questions if q[0] == "hardware"},
                       key=lambda sp: sp.describe())
        burst = [("hardware", specs[i % len(specs)], workload, h1, h3)
                 for i in range(SERVE_QUESTIONS)]
        _ask_coalesced(svc, burst)
        hw_new = hardware.analytical_profile(
            "HW-new", mem_ns=60.0, bw_bytes_per_s=80e9, l3_bytes=64 << 20)
        svc.register_hardware(hw_new)
        before = devicecost.specialisation_count()
        swapped = _ask_coalesced(svc, [(k, sp, wl, base, hw_new)
                                       for k, sp, wl, base, _ in burst])
        asked += 2 * SERVE_QUESTIONS
        out["hw_swap_new_specialisations"] = \
            devicecost.specialisation_count() - before
        assert out["hw_swap_new_specialisations"] == 0, \
            "the hardware-swap burst added K0 specialisations"
        assert all(a.engine == "fused" for a in swapped)

        serial_s, coalesced_s = [], []
        serial_lat, coalesced_lat = [], []
        for _ in range(SERVE_REPS):
            t0 = time.perf_counter()
            for q in questions:
                t1 = time.perf_counter()
                _ask_serial(q)
                serial_lat.append(time.perf_counter() - t1)
            serial_s.append(time.perf_counter() - t0)
            stats0 = svc.stats()
            k0_0 = launch_counts().get("bank_score", 0)
            t0 = time.perf_counter()
            _check_answers(questions, _ask_coalesced(svc, questions,
                                                     coalesced_lat),
                           serial, oracles)
            coalesced_s.append(time.perf_counter() - t0)
            asked += len(questions)
            stats1 = svc.stats()
        windows = stats1["batches"] - stats0["batches"]
        out["k0_launches_per_window"] = \
            (launch_counts().get("bank_score", 0) - k0_0) / max(windows, 1)
        out["score_calls_per_window"] = \
            (stats1["score_calls"] - stats0["score_calls"]) / max(windows, 1)
        out["windows_per_burst"] = windows
        out["serial_s"], out["coalesced_s"] = serial_s, coalesced_s
        out["serial_qps"] = SERVE_QUESTIONS / min(serial_s)
        out["coalesced_qps"] = SERVE_QUESTIONS / min(coalesced_s)
        out["coalesced_over_serial"] = \
            out["coalesced_qps"] / out["serial_qps"]
        out["reference_bar"] = SERVE_TARGET
        out["serial_latency_p50_ms"] = _pct(serial_lat, 50) * 1e3
        out["serial_latency_p99_ms"] = _pct(serial_lat, 99) * 1e3
        out["coalesced_latency_p50_ms"] = _pct(coalesced_lat, 50) * 1e3
        out["coalesced_latency_p99_ms"] = _pct(coalesced_lat, 99) * 1e3
        # one coalesced window, traced: K0's launches and device time,
        # the card's busy share of the window
        out["profile_window"] = _profile(
            lambda: _ask_coalesced(svc, questions), 1, watch="bank_score")
        asked += len(questions)
        stats = svc.stats()
    finally:
        svc.stop()
    out["stats"] = {k: stats[k] for k in (
        "questions", "answered", "failed", "batches", "score_calls",
        "fallback_flat", "fallback_grouped", "shard_retries",
        "shard_nonfinite")}
    assert stats["answered"] == asked == stats["questions"], stats
    assert stats["failed"] == 0, stats
    assert stats["fallback_flat"] == stats["fallback_grouped"] == 0, stats

    out["sweep"] = _serving_sweep()
    out["search"] = _serving_search(workload, h3)
    out["healing"] = _serving_healing(workload, h1)
    out["path_s"] = time.perf_counter() - t_path
    out["launches"] = launch_counts()
    assert out["launches"].get("bank_score", 0) > 0, "K0 never launched"
    return out


def _serving_sweep() -> dict:
    """The whatif phase's question through ``submit_sweep``: on a pool
    of one slot (one K0 launch) and on two slots of ``cuda:0`` forced to
    split (two launches, each on its slot's stream), both grids bit for
    bit the direct ``whatif.workload_sweep``'s."""
    from repro_torch.core import (autocomplete, batchcost, devicecost,
                                  hardware, whatif)
    from repro_torch.core.synthesis import Workload
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import DesignCalculatorService
    frontier = autocomplete.enumerate_frontier((), max_depth=DEPTH)
    workloads = [Workload(n_entries=1_000_000, n_queries=100)] * N_POINTS
    mixes = whatif.read_fraction_mixes(np.linspace(0.0, 1.0, N_POINTS))
    hw3 = hardware.hw3()
    direct = whatif.workload_sweep(frontier, workloads, hw3, mixes).totals
    out = {"designs": len(frontier), "points": N_POINTS,
           "cells": N_POINTS * len(batchcost.pack_sweep(
               frontier, workloads, mixes).frontiers[0].ids)}
    for label, devices in (("one_slot", None),
                           ("two_slots", [DEVICE + ":0"] * 2)):
        svc = DesignCalculatorService([hw3], window_s=0.002,
                                      scoring_devices=devices,
                                      shard_min_cells=1)
        try:
            grids, secs, launches = [], [], []
            for _ in range(3):      # the first lays out the parts
                k0 = launch_counts().get("bank_score", 0)
                t0 = time.perf_counter()
                ans = svc.workload_sweep(frontier, workloads, hw3, mixes)
                secs.append(time.perf_counter() - t0)
                launches.append(launch_counts().get("bank_score", 0) - k0)
                assert ans.engine == "fused", ans.engine
                grids.append(ans.totals)
            stats = svc.stats()
        finally:
            svc.stop()
        want = 1 if devices is None else 2
        assert launches == [want] * 3, f"{label}: K0 launches {launches}"
        for g in grids:
            assert np.array_equal(g, direct), f"{label}: grid differs"
        assert stats["fallback_flat"] == stats["fallback_grouped"] == 0
        out[label] = {"slots": 1 if devices is None else len(devices),
                      "k0_launches_per_sweep": launches[-1],
                      "first_s": secs[0], "repeat_s": secs[1:],
                      "shard_dispatches": stats["shard_dispatches"],
                      "bit_identical_to_direct": True}
    # K0 on the whole grid and on each of the pool's two parts (the
    # memoized split, laid out by the two-slot run), CUDA events, in turns
    import torch
    dev = torch.device(DEVICE, 0)
    table = devicecost.device_table(hw3, dev)
    sweep = batchcost.pack_sweep(frontier, workloads, mixes)
    layouts = [sweep._sweep_arrays(dev)] + \
        [part._sweep_arrays(dev) for part in sweep.split(2)]

    def k0_ms(ds):
        return timed_ms(lambda: devicecost.bank_score(
            table.banks, *ds.arrays, table.has_knn))
    turns = [[k0_ms(ds) for ds in layouts] for _ in range(2)]
    out["k0_whole_ms"] = [t[0] for t in turns]
    out["k0_part_ms"] = [t[1:] for t in turns]
    out["part_records"] = [len(ds.host_ids) for ds in layouts[1:]]
    return out


def _serving_search(workload, hw3) -> dict:
    """The popsearch configuration through ``submit_search``: the direct
    ``population_search``'s winner and cost, within 1e-6 of the
    oracle."""
    from repro_torch.core import search
    from repro_torch.core.synthesis import cost_workload
    from repro_torch.serving import DesignCalculatorService
    mix = {"get": 80.0, "update": 20.0}
    direct = search.population_search(
        workload, hw3, mix, budget=search.SearchBudget(SEARCH_BUDGET),
        seeds=_starts(), **SEARCH_KW)
    with DesignCalculatorService([hw3], window_s=0.002) as svc:
        t0 = time.perf_counter()
        served = svc.submit_search(
            workload, hw3, mix, budget_designs=SEARCH_BUDGET,
            seeds=_starts(), **SEARCH_KW).result(timeout=600)
        took = time.perf_counter() - t0
        stats = svc.stats()
    assert served["design"].chain == direct["design"].chain, \
        (served["design"].describe(), direct["design"].describe())
    assert served["cost_s"] == direct["cost_s"], \
        (served["cost_s"], direct["cost_s"])
    oracle = cost_workload(served["design"], workload, hw3, mix)
    rel = _oracle_rel(served["cost_s"], oracle)
    assert rel <= ORACLE_RTOL, f"served search vs oracle {rel:.3e}"
    assert stats["fallback_flat"] == stats["fallback_grouped"] == 0
    return {"design": served["design"].describe(),
            "cost_s": served["cost_s"], "oracle_rel_err": rel,
            "designs_costed": served["designs_costed"],
            "generations": served["generations"], "served_s": took,
            "sweeps": stats["sweeps"], "answered": stats["answered"]}


def _serving_healing(workload, h1) -> dict:
    """A corrupt fused total heals inside the pool (retried on the slot,
    still the fused engine).  Corrupt banks fail the question (on the
    card the host's grouped oracle never answers), and the recovery
    probe rebuilds the banks and brings the fused engine back."""
    from repro_torch.core import devicecost, elements as el, whatif
    from repro_torch.serving import (DesignCalculatorService,
                                     FusedEngineDown, NonFiniteScore)
    from repro_torch.testing.faults import FaultPlan, FaultRule
    q = (el.spec_btree(), el.spec_csb_tree(), workload, h1)
    oracle = whatif.what_if_design(*q, engine="scalar")
    out = {}
    probe_s = 0.3
    with DesignCalculatorService([h1], window_s=0.002,
                                 engine_probe_s=probe_s) as svc:
        svc.what_if_design(*q)
        plan = FaultPlan(11, [FaultRule("devicecost.fused", kind="corrupt",
                                        at=(0,))])
        with plan.activate():
            got = svc.what_if_design(*q)
        stats = svc.stats()
        assert plan.fires("devicecost.fused") == 1
        assert got.engine == "fused", got.engine
        assert _oracle_rel(got.baseline_seconds,
                           oracle.baseline_seconds) <= ORACLE_RTOL
        assert stats["shard_nonfinite"] >= 1 and \
            stats["shard_retries"] >= 1, stats
        assert stats["fallback_grouped"] == 0, stats
        out["fused_corrupt"] = {k: stats[k] for k in (
            "shard_nonfinite", "shard_retries", "fallback_flat",
            "fallback_grouped")}

        devicecost.invalidate_table(h1)
        plan = FaultPlan(13, [FaultRule("devicecost.banks", kind="corrupt",
                                        rate=1.0, max_fires=1)])
        with plan.activate():
            try:
                svc.what_if_design(*q)
            except NonFiniteScore:
                pass
            else:
                raise AssertionError("corrupt banks answered a question")
        assert plan.fires("devicecost.banks") == 1
        assert svc.health()["engines"][h1.name]["engine"] == "down"
        try:
            svc.what_if_design(*q)
        except FusedEngineDown:
            refused = True
        else:
            refused = False
        time.sleep(probe_s + 0.05)
        back = svc.what_if_design(*q)
        stats = svc.stats()
        assert back.engine == "fused", back.engine
        assert stats["engine_recovered"] == 1, stats
        assert stats["fallback_grouped"] == 0, stats
        assert _oracle_rel(back.baseline_seconds,
                           oracle.baseline_seconds) <= ORACLE_RTOL
        assert _oracle_rel(back.variant_seconds,
                           oracle.variant_seconds) <= ORACLE_RTOL
        out["banks_corrupt"] = {k: stats[k] for k in (
            "nonfinite_groups", "failed", "fallback_grouped",
            "engine_degraded", "engine_recovered")}
        out["banks_corrupt"]["refused_while_down"] = refused
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


def _profile(fn, steps: int, watch: str = "", spans=()) -> dict:
    """torch.profiler over ``steps`` calls of ``fn``: device and host time
    per call, the kernels that take the most device time, the host-to-
    device copies, the device time of each launch of the kernels whose
    name holds ``watch``, and the device time of the kernels launched
    inside each ``torch.profiler.record_function`` span named in
    ``spans``."""
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
    # operator events that launched them report the same time again, and
    # a span's GPU-side annotation spans its kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in spans]

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def dev_total(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

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
    for name in spans:
        hits = [e for e in events if e.key == name and
                e.device_type == torch.autograd.DeviceType.CPU]
        out[f"span_{name}_calls_per_step"] = sum(e.count for e in hits) / steps
        out[f"span_{name}_device_ms_per_step"] = sum(
            dev_total(e) for e in hits) / 1e3 / steps
        out[f"span_{name}_host_ms_per_step"] = sum(
            e.cpu_time_total for e in hits) / 1e3 / steps
    if watch:
        hits = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and watch in e.name]
        each = [e.time_range.elapsed_us() / 1e3 for e in hits]
        out[f"{watch}_launches_per_step"] = len(each) / steps
        out[f"{watch}_kernels"] = {}
        out[f"{watch}_ms_by_kernel"] = {}
        for e, ms in zip(hits, each):
            name = e.name[:80]
            out[f"{watch}_kernels"][name] = \
                out[f"{watch}_kernels"].get(name, 0) + 1
            out[f"{watch}_ms_by_kernel"][name] = \
                out[f"{watch}_ms_by_kernel"].get(name, 0.0) + ms / steps
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
                reset_launch_counts()
                logits, cache = make_prefill_step(m, max_len)(params,
                                                              prompt_t)
                res[impl, dtype] = (logits.float(), cache)
                if (impl, dtype) == ("flash", "float32"):
                    f32_launches = _k5_moved({}, launch_counts())
    torch.cuda.synchronize()
    # the float32 prefill: every K5 launch on the tf32x3 variant
    assert f32_launches.get("flash_attention") == cfg.n_layers and \
        f32_launches.get("flash_attention_tf32x3") == cfg.n_layers and \
        f32_launches.get("flash_attention_wgmma", 0) == 0, \
        f"the float32 prefill's K5 launches {f32_launches}, expected " \
        f"{cfg.n_layers}, all tf32x3"
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
           "float32_flash_launches": f32_launches,
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
# families: every other model family at its published widths
# ---------------------------------------------------------------------------
#: 4 prompts: granite-moe and pixtral prefill 2,048 positions (pixtral:
#: 256 patches + 1,792 tokens) and decode 32 steps; zamba2 and xlstm
#: forward 2,048 tokens and serve 64-token prompts by stepping, then 16
#: decode steps; seamless encodes 1,024 frames and decodes 512 tokens
FAM_BATCH, FAM_SEQ, FAM_DECODE = 4, 2048, 32
STEP_PROMPT, STEP_DECODE = 64, 16
SRC_LEN, TGT_LEN = 1024, 512
#: the reference's decode-vs-forward tolerance (tests/test_arch_smoke.py)
DECODE_TOL = 6e-2
#: bf16 decode's rms distance from float32 decode, at most this times
#: bf16 forward's from float32 forward (0.97-1.01 in both packages at
#: full width cut to a few layers, on the CPU:
#: scripts/bf16_decode_witness.py)
BF16_DECODE_RATIO = 1.5
#: the spans the port's models open around their MoE layer and scans
SPANS = ("moe_ffn", "chunked_linear_scan", "slstm_scan")
#: xlstm's float32 forward on the host's CPU: the first sequence's tokens
HOST_TOKENS = 128
#: sLSTM steps traced (of FAM_SEQ): a step's kernels have the same shapes
#: at every position, and a trace of all 6 x 2,048 steps' ~250k events
#: takes minutes to collect
SLSTM_TRACED_STEPS = 256


def _rms(a, b) -> float:
    return float((a.float() - b.float()).pow(2).mean().sqrt())


def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gb() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _k5_moved(before, after) -> dict:
    return {n: after.get(n, 0) - before.get(n, 0) for n in after
            if n.startswith("flash_attention")}


class Checks:
    """The families phase's checks: each failure is kept, so one run
    reports every family's numbers, and :meth:`raise_any` fails the
    phase at its end."""

    def __init__(self) -> None:
        self.failures = []

    def expect(self, ok: bool, msg: str) -> None:
        if not ok:
            self.failures.append(msg)
            log(f"CHECK FAILED: {msg}")

    def raise_any(self) -> None:
        assert not self.failures, "; ".join(self.failures)


def _against_plain(cfg, fn, checks: Checks, k5_want: int) -> dict:
    """``fn(cfg)`` -> {name: tensor} under flash attention (K5) and the
    plain chunked path, in float32 and bf16 compute, on the same weights:
    float32 flash within LM_TOL of float32 plain, and in bf16 the flash
    path no further (rms, 1.25x) from the float32 plain result than the
    bf16 plain path is (the lm phase's checks).  The float32 flash run
    launches K5 ``k5_want`` times, every one on the tf32x3 variant."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    res = {}
    with torch.no_grad():
        for impl in ("flash", "xla"):
            for dtype in ("float32", "bfloat16"):
                reset_launch_counts()
                got = fn(dataclasses.replace(cfg, attn_impl=impl,
                                             compute_dtype=dtype))
                res[impl, dtype] = {k: v.float() for k, v in got.items()}
                if (impl, dtype) == ("flash", "float32"):
                    k5 = _k5_moved({}, launch_counts())
    torch.cuda.synchronize()
    out = {"float32_flash_k5_launches": k5}
    checks.expect(k5.get("flash_attention") == k5_want and
                  k5.get("flash_attention_tf32x3") == k5_want and
                  k5.get("flash_attention_wgmma", 0) == 0,
                  f"{cfg.arch_id}: the float32 flash run's K5 launches "
                  f"{k5}, expected {k5_want}, all tf32x3")
    for name, want in res["xla", "float32"].items():
        f32 = res["flash", "float32"][name]
        row = {"float32_flash_vs_plain_max_abs": _max_abs(f32, want)}
        for impl in ("flash", "xla"):
            row[f"bf16_{impl}_vs_float32_rms"] = _rms(
                res[impl, "bfloat16"][name], want)
            row[f"bf16_{impl}_vs_float32_max_abs"] = _max_abs(
                res[impl, "bfloat16"][name], want)
        checks.expect(_within(f32, want, LM_TOL),
                      f"{cfg.arch_id} {name}: flash vs plain (float32): "
                      f"{row}")
        checks.expect(row["bf16_flash_vs_float32_rms"] <=
                      1.25 * row["bf16_xla_vs_float32_rms"],
                      f"{cfg.arch_id} {name}: bf16 flash further from "
                      f"float32 than the plain path: {row}")
        out[name] = row
    return out


def _against_host(cfg, params, tokens, served_logits, checks: Checks
                  ) -> dict:
    """A model without attention (xLSTM) has no flash/plain pair: its
    float32 forward on the card against the same forward on the host's
    CPU (the first sequence, HOST_TOKENS tokens) within LM_TOL.  The
    served bf16 logits (``served_logits``) against the card's float32
    ones are recorded, not gated: bf16 rounding alone exceeds LM_TOL's
    max-abs form already at the smoke config (0.079)."""
    import dataclasses
    import torch
    from repro_torch.models import build
    from repro_torch.models.convert import tree_to
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        card = build(f32).forward(params, tokens)[0].float()
        host_params = tree_to(params, "cpu")
        t0 = time.perf_counter()
        host = build(f32).forward(host_params,
                                  tokens[:1, :HOST_TOKENS].cpu())[0]
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    part = card[:1, :HOST_TOKENS].cpu()
    row = {"float32_card_vs_host_max_abs": _max_abs(part, host),
           "host_tokens": HOST_TOKENS, "host_s": host_s,
           "bf16_vs_float32_rms": _rms(served_logits, card),
           "bf16_vs_float32_max_abs": _max_abs(served_logits, card)}
    checks.expect(_within(part, host, LM_TOL),
                  f"{cfg.arch_id}: float32 on the card vs the host: {row}")
    return {"logits": row}


def _decode_vs_forward(model, params, prompts, checks: Checks) -> dict:
    """Step the prompts through the decode closure and hold each step's
    logits against the full forward's at that position, in float32
    compute within DECODE_TOL (the reference's check).  In the config's
    bf16 the two paths round apart by more than that at full width, in
    the reference too (scripts/bf16_decode_witness.py, PERF.md §6), so
    bf16 is held by a witness instead: each bf16 path against the same
    path in float32, the decode no further (rms) than BF16_DECODE_RATIO
    times the forward.  A fault in the bf16 step path (its casts) would
    move the decode alone."""
    import dataclasses
    import torch
    from repro_torch.models import build
    from repro_torch.train.serve import make_serve_step
    b, s = prompts.shape
    out = {"positions": s}
    logits = {}
    for dtype in ("bfloat16", "float32"):
        m = build(dataclasses.replace(model.cfg, compute_dtype=dtype))
        with torch.no_grad():
            full, _ = m.forward(params, prompts)
            cache = m.init_cache(b, s, device=DEVICE)
            step = make_serve_step(m)
            pos = torch.zeros((b,), dtype=torch.int32, device=DEVICE)
            steps = []
            for t in range(s):
                got, cache = step(params, cache, prompts[:, t], pos)
                pos = pos + 1
                steps.append(got.float())
        logits[dtype] = (full.float(), torch.stack(steps, dim=1))
        out[f"{dtype}_max_abs"] = _max_abs(*logits[dtype][::-1])
        out[f"{dtype}_rms"] = _rms(*logits[dtype])
    (bf, bd), (ff, fd) = logits["bfloat16"], logits["float32"]
    out["bf16_forward_vs_float32_rms"] = _rms(bf, ff)
    out["bf16_decode_vs_float32_rms"] = _rms(bd, fd)
    out["bf16_ratio"] = (out["bf16_decode_vs_float32_rms"] /
                         out["bf16_forward_vs_float32_rms"])
    arch = model.cfg.arch_id
    checks.expect(_within(fd, ff, DECODE_TOL),
                  f"{arch}: decode vs forward (float32) max abs "
                  f"{out['float32_max_abs']:.3e}")
    checks.expect(out["bf16_ratio"] <= BF16_DECODE_RATIO,
                  f"{arch}: bf16 decode further from float32 than the "
                  f"bf16 forward: {out}")
    return out


def _served(cfg, params, prompts, new, embeds=None, max_len=None
            ) -> dict:
    """``serve_batch`` once to warm, then the counted run: its launches,
    seconds and tokens."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_batch
    serve_batch(cfg, prompts[:, :8], 2, params=params, log=lambda _: None,
                embeds=None if embeds is None else embeds[:, :8])
    reset_launch_counts()
    run = serve_batch(cfg, prompts, new, params=params, embeds=embeds,
                      max_len=max_len, log=lambda _: None)
    launches = launch_counts()
    tokens = run["tokens"]
    assert tokens.shape == (prompts.shape[0], new), tokens.shape
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    return {"prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
            "decode_tok_s": prompts.shape[0] * (new - 1) / run["decode_s"],
            "k5_launches": _k5_moved({}, launches),
            "moe_combine_launches": launches.get("moe_combine", 0),
            "first_tokens": tokens[:, :8].tolist(), "run": run}


def _family_granite(seed: int, checks: Checks) -> dict:
    """granite-moe-1b-a400m at full width and depth: fused prefill of 4 x
    2,048 tokens (K5, 24 launches) and 32 decode steps."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch import tracing
    from repro_torch.models import moe as M
    from repro_torch.train.serve import make_prefill_step
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              attn_impl="flash")
    model = build(cfg)
    params = model.init(seed, device=DEVICE)
    rng = np.random.default_rng(seed + 11)
    prompts = rng.integers(0, cfg.vocab_size,
                           (FAM_BATCH, FAM_SEQ)).astype(np.int32)
    max_len = FAM_SEQ + FAM_DECODE
    out = _served(cfg, params, prompts, FAM_DECODE + 1, max_len=max_len)
    run = out.pop("run")
    k5 = out["k5_launches"]
    checks.expect(k5.get("flash_attention") == cfg.n_layers and
                  k5.get("flash_attention_wgmma") == cfg.n_layers,
                  f"granite-moe prefill K5 launches {k5}")
    # the combine kernel once a layer, in the prefill and each decode step
    checks.expect(out["moe_combine_launches"] ==
                  cfg.n_layers * (1 + FAM_DECODE),
                  f"granite-moe serve_batch moe_combine launches "
                  f"{out['moe_combine_launches']}, expected "
                  f"{cfg.n_layers * (1 + FAM_DECODE)}")
    checks.expect(bool(torch.isfinite(run["prefill_logits"].float()).all()),
                  "granite-moe prefill logits not finite")
    prompt_t = torch.as_tensor(prompts, device=DEVICE)

    def last_logits(c):
        logits, _ = make_prefill_step(build(c), max_len)(params, prompt_t)
        return {"logits": logits}

    t0 = time.perf_counter()
    out["vs_plain"] = _against_plain(cfg, last_logits, checks,
                                     cfg.n_layers)
    out["vs_plain_s"] = time.perf_counter() - t0
    # one prefill traced: the MoE spans' device time, and the tokens
    # dropped by capacity from the layers' own tallies
    prefill = make_prefill_step(model, max_len)
    tracing.reset_tallies()
    with torch.no_grad():
        out["profile_prefill"] = _profile(lambda: prefill(params, prompt_t),
                                          1, watch="flash", spans=SPANS)
    tallied = tracing.tallies()
    out["capacity"] = M.capacity(FAM_BATCH * FAM_SEQ, cfg)
    out["assignments"] = tallied["moe.assigned"]
    out["dropped_assignments"] = tallied["moe.assigned"] - tallied["moe.kept"]
    return out


def _family_scan(arch: str, seed: int, checks: Checks) -> dict:
    """zamba2-1.2b or xlstm-350m at full width and depth: forward on 4 x
    2,048 tokens (zamba2: K5 on its 7 shared-attention applications),
    held against the plain path (xlstm: bf16 against float32); the
    launcher on 4 prompts of 64 tokens, stepped, and 16 decode steps;
    decode against forward over those 64 positions."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build
    from repro_torch.models.hybrid import n_shared_applications
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    model = build(cfg)
    params = model.init(seed, device=DEVICE)
    rng = np.random.default_rng(seed + 12)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (FAM_BATCH, FAM_SEQ)).astype(np.int32),
        device=DEVICE)
    with torch.no_grad():
        model.forward(params, tokens[:, :16])             # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, tokens)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
    k5 = _k5_moved({}, launch_counts())
    attention = cfg.family == "hybrid"
    want = n_shared_applications(cfg) if attention else 0
    checks.expect(k5.get("flash_attention", 0) == want and
                  k5.get("flash_attention_wgmma", 0) == want,
                  f"{arch} forward K5 launches {k5}, expected {want}")
    checks.expect(bool(torch.isfinite(logits.float()).all()),
                  f"{arch} forward logits not finite")
    out = {"forward_s": forward_s,
           "forward_tok_s": FAM_BATCH * FAM_SEQ / forward_s,
           "forward_k5_launches": k5}

    def full_logits(c):
        return {"logits": build(c).forward(params, tokens)[0]}

    t0 = time.perf_counter()
    if attention:
        del logits
        out["vs_plain"] = _against_plain(cfg, full_logits, checks, want)
    else:
        out["vs_plain"] = _against_host(cfg, params, tokens, logits.float(),
                                        checks)
        del logits
    out["vs_plain_s"] = time.perf_counter() - t0
    prompts = rng.integers(0, cfg.vocab_size,
                           (FAM_BATCH, STEP_PROMPT)).astype(np.int32)
    served = _served(cfg, params, prompts, STEP_DECODE + 1)
    served.pop("run")
    out["served"] = served
    t0 = time.perf_counter()
    out["decode_vs_forward"] = _decode_vs_forward(
        model, params, torch.as_tensor(prompts, device=DEVICE), checks)
    out["decode_vs_forward_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        if attention:
            out["profile_forward"] = _profile(
                lambda: model.forward(params, tokens, hidden=True), 1,
                watch="flash", spans=SPANS)
        else:
            out.update(_xlstm_blocks(cfg, params, tokens))
    out["profile_s"] = time.perf_counter() - t0
    return out


def _xlstm_blocks(cfg, params, tokens) -> dict:
    """One sLSTM block timed at full length on the host clock; one trace
    of an mLSTM block at full length (its chunked scan's span) and of the
    sLSTM block over its first SLSTM_TRACED_STEPS steps (its loop's span
    per step)."""
    import torch
    from repro_torch.models import ssm as S
    from repro_torch.models import layers as L
    x = L.embed(params["embed"], tokens, cfg)
    kinds = [b for b in params["blocks"] if "slstm" in b]
    mlstm = next(b for b in params["blocks"] if "mlstm" in b)["mlstm"]
    slstm = kinds[0]["slstm"]
    out = {"mlstm_blocks": len(params["blocks"]) - len(kinds),
           "slstm_blocks": len(kinds)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S.slstm_forward(slstm, x, cfg)
    torch.cuda.synchronize()
    out["slstm_block_s"] = time.perf_counter() - t0
    short = x[:, :SLSTM_TRACED_STEPS]

    def blocks():
        S.mlstm_forward(mlstm, x, cfg)
        S.slstm_forward(slstm, short, cfg)

    prof = _profile(blocks, 1, spans=SPANS)
    out["profile_blocks"] = prof
    out["profile_slstm_steps"] = SLSTM_TRACED_STEPS
    out["slstm_device_ms_per_step"] = (
        prof["span_slstm_scan_device_ms_per_step"] / SLSTM_TRACED_STEPS)
    out["slstm_host_ms_per_step"] = (
        prof["span_slstm_scan_host_ms_per_step"] / SLSTM_TRACED_STEPS)
    out["mlstm_scan_device_ms_per_block"] = prof[
        "span_chunked_linear_scan_device_ms_per_step"]
    return out


def _family_seamless(seed: int, checks: Checks) -> dict:
    """seamless-m4t-large-v2 at full width and depth: encode 4 x 1,024
    frames (K5 non-causal), forward 4 x 512 target tokens (K5 causal and
    cross-attention with Sq 512, Skv 1,024), prefill_cross and 16 decode
    steps, each held against the plain path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build, encdec
    from repro_torch.models import layers as L
    from repro_torch.train.serve import greedy_sample, make_serve_step
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              attn_impl="flash")
    model = build(cfg)
    params = model.init(seed, device=DEVICE)
    rng = np.random.default_rng(seed + 13)
    src = torch.as_tensor(rng.standard_normal(
        (FAM_BATCH, SRC_LEN, cfg.d_model)).astype(np.float32), device=DEVICE)
    tgt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (FAM_BATCH, TGT_LEN)).astype(np.int32),
        device=DEVICE)
    n = cfg.n_layers
    out = {}
    with torch.no_grad():
        model.forward(params, tgt[:, :64], embeds=src[:, :128], hidden=True)
        torch.cuda.synchronize()
        for name, fn, want in (
                ("encode", lambda: encdec.encode(params, src, cfg),
                 cfg.n_encoder_layers),
                ("forward", lambda: model.forward(params, tgt, embeds=src,
                                                  hidden=True),
                 cfg.n_encoder_layers + 2 * n)):
            reset_launch_counts()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[f"{name}_s"] = time.perf_counter() - t0
            k5 = _k5_moved({}, launch_counts())
            out[f"{name}_k5_launches"] = k5
            checks.expect(k5.get("flash_attention") == want and
                          k5.get("flash_attention_wgmma") == want,
                          f"seamless {name} K5 launches {k5}, expected "
                          f"{want}")

    def outputs(c):
        hid, _ = build(c).forward(params, tgt, embeds=src, hidden=True)
        return {"encoder": encdec.encode(params, src, c),
                "last_logits": L.unembed(params["embed"], hid[:, -1:], c)}

    t0 = time.perf_counter()
    out["vs_plain"] = _against_plain(
        cfg, outputs, checks, 2 * cfg.n_encoder_layers + 2 * n)
    out["vs_plain_s"] = time.perf_counter() - t0
    # served: prefill_cross on K5 (bf16), then 16 greedy decode steps
    step = make_serve_step(model)
    with torch.no_grad():
        reset_launch_counts()
        t0 = time.perf_counter()
        cache = encdec.prefill_cross(
            params, src, cfg, encdec.init_cache(cfg, FAM_BATCH,
                                                STEP_DECODE + 1,
                                                src_len=SRC_LEN,
                                                device=DEVICE))
        torch.cuda.synchronize()
        out["prefill_cross_s"] = time.perf_counter() - t0
        k5 = _k5_moved({}, launch_counts())
        out["prefill_cross_k5_launches"] = k5
        checks.expect(k5.get("flash_attention") == cfg.n_encoder_layers and
                      k5.get("flash_attention_wgmma") ==
                      cfg.n_encoder_layers,
                      f"seamless prefill_cross K5 launches {k5}")
        token = tgt[:, 0]
        t0 = time.perf_counter()
        for t in range(STEP_DECODE):
            pos = torch.full((FAM_BATCH,), t, dtype=torch.int32,
                             device=DEVICE)
            logits, cache = step(params, cache, token, pos)
            token = greedy_sample(logits)
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
        out["decode_tok_s"] = FAM_BATCH * STEP_DECODE / out["decode_s"]
        checks.expect(bool(torch.isfinite(logits.float()).all()),
                      "seamless decode logits not finite")
        out["profile_forward"] = _profile(
            lambda: model.forward(params, tgt, embeds=src, hidden=True), 1,
            watch="flash")
        del cache
        # the same 16 steps in float32 from the flash path's cross cache
        # and from the plain path's, each step's logits against the other
        caches = {}
        for impl in ("flash", "xla"):
            c = dataclasses.replace(cfg, attn_impl=impl,
                                    compute_dtype="float32")
            reset_launch_counts()
            caches[impl] = encdec.prefill_cross(
                params, src, c, encdec.init_cache(c, FAM_BATCH,
                                                  STEP_DECODE + 1,
                                                  src_len=SRC_LEN,
                                                  device=DEVICE))
            if impl == "flash":
                k5 = _k5_moved({}, launch_counts())
                out["prefill_cross_float32_k5_launches"] = k5
                checks.expect(
                    k5.get("flash_attention") == cfg.n_encoder_layers and
                    k5.get("flash_attention_tf32x3") ==
                    cfg.n_encoder_layers,
                    f"seamless prefill_cross (float32) K5 launches {k5}")
        out["prefill_cross_vs_plain_max_abs"] = {
            name: _max_abs(caches["flash"][name], caches["xla"][name])
            for name in ("xk", "xv")}
        for name in ("xk", "xv"):
            checks.expect(_within(caches["flash"][name], caches["xla"][name],
                                  LM_TOL),
                          f"seamless prefill_cross {name} vs plain "
                          f"(float32): {out['prefill_cross_vs_plain_max_abs']}")
        step32 = make_serve_step(build(dataclasses.replace(
            cfg, compute_dtype="float32")))
        token = tgt[:, 0]
        worst, ok = 0.0, True
        for t in range(STEP_DECODE):
            pos = torch.full((FAM_BATCH,), t, dtype=torch.int32,
                             device=DEVICE)
            logits, caches["flash"] = step32(params, caches["flash"], token,
                                             pos)
            plain, caches["xla"] = step32(params, caches["xla"], token, pos)
            worst = max(worst, _max_abs(logits, plain))
            ok = ok and _within(logits, plain, LM_TOL)
            token = greedy_sample(plain)
        out["decode_vs_plain_max_abs"] = worst
        checks.expect(ok, f"seamless decode (float32) from the flash cache "
                          f"vs the plain one: max abs {worst:.3e}")
    return out


def _family_pixtral(seed: int, checks: Checks) -> dict:
    """pixtral-12b at full width and depth (bf16 parameters): 256 patch
    embeddings + 1,792 tokens, x 4, through the fused prefill (K5's
    tensor-core variant at D 160, 40 launches, none on tf32x3) and 32
    decode steps."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train.serve import make_prefill_step
    cfg = dataclasses.replace(get_config("pixtral-12b"), attn_impl="flash")
    model = build(cfg)
    params = model.init(seed, device=DEVICE)
    rng = np.random.default_rng(seed + 14)
    p = cfg.n_patches
    prompts = rng.integers(0, cfg.vocab_size,
                           (FAM_BATCH, FAM_SEQ - p)).astype(np.int32)
    patches = torch.as_tensor(rng.standard_normal(
        (FAM_BATCH, p, cfg.d_model)).astype(np.float32), device=DEVICE)
    max_len = FAM_SEQ + FAM_DECODE
    out = _served(cfg, params, prompts, FAM_DECODE + 1, embeds=patches,
                  max_len=max_len)
    run = out.pop("run")
    k5 = out["k5_launches"]
    checks.expect(k5.get("flash_attention") == cfg.n_layers and
                  k5.get("flash_attention_wgmma") == cfg.n_layers and
                  k5.get("flash_attention_tf32x3", 0) == 0,
                  f"pixtral prefill K5 launches {k5}")
    checks.expect(bool(torch.isfinite(run["prefill_logits"].float()).all()),
                  "pixtral prefill logits not finite")
    prompt_t = torch.as_tensor(prompts, device=DEVICE)

    def last_logits(c):
        logits, _ = make_prefill_step(build(c), max_len)(params, prompt_t,
                                                         patches)
        return {"logits": logits}

    t0 = time.perf_counter()
    out["vs_plain"] = _against_plain(cfg, last_logits, checks,
                                     cfg.n_layers)
    out["vs_plain_s"] = time.perf_counter() - t0
    prefill = make_prefill_step(model, max_len)
    with torch.no_grad():
        out["profile_prefill"] = _profile(
            lambda: prefill(params, prompt_t, patches), 1,
            watch="flash")
    return out


def phase_families(seed: int) -> dict:
    """Each family at its published widths, one model at a time, its
    memory freed before the next; peak memory per model.  Every check
    of every model runs before the phase fails on any."""
    import functools
    import torch
    from repro_torch.configs import get_config
    checks = Checks()
    out = {}
    for name, fn in (("granite-moe-1b-a400m", _family_granite),
                     ("zamba2-1.2b", functools.partial(_family_scan,
                                                       "zamba2-1.2b")),
                     ("xlstm-350m", functools.partial(_family_scan,
                                                      "xlstm-350m")),
                     ("seamless-m4t-large-v2", _family_seamless),
                     ("pixtral-12b", _family_pixtral)):
        _free()
        t0 = time.perf_counter()
        res = fn(seed, checks)
        torch.cuda.synchronize()
        cfg = get_config(name)
        res.update({"phase_s": time.perf_counter() - t0,
                    "peak_gb": _peak_gb(), "layers": cfg.n_layers,
                    "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                    "params_b": cfg.n_params() / 1e9})
        out[name] = res
        log(f"families {name}: " + json.dumps(res))
    _free()
    out["failures"] = checks.failures
    checks.raise_any()
    return out


# ---------------------------------------------------------------------------
# train: qwen2-1.5b trained on the card through repro_torch.launch.train
# ---------------------------------------------------------------------------
#: 4 sequences of 2,048 tokens a step, 8 steps, a checkpoint every 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 4, 2048, 8, 4
#: the first step, float32 compute, flash (K5's tf32x3 forward and
#: backward) against the plain chunked path: loss and grad_norm within
#: this relative distance (the paths differ only in attention's summation
#: order and the backward's 3xTF32 products, ~1e-6 relative an output)
TRAIN_F32_RTOL = 1e-4
#: bf16 compute: the flash step's gradient no further (rms) from the
#: float32 plain gradient than this times the bf16 plain step's is (the
#: lm phase's witness)
TRAIN_BF16_RATIO = 1.25


def _grads_rms(a, b) -> float:
    """rms over every entry of two gradient trees."""
    from repro_torch.optim.adamw import tree_leaves
    sq, n = 0.0, 0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        sq += float((x.float() - y.float()).pow(2).sum())
        n += x.numel()
    return math.sqrt(sq / n)


def _grad_norm(grads) -> float:
    from repro_torch.optim.adamw import tree_leaves
    return math.sqrt(sum(float(g.float().pow(2).sum())
                         for g in tree_leaves(grads)))


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one step, recompute not counted: 6 N T for the
    matrix products of the parameters (the tied embedding's one product
    included) plus the causal attention products, forward 4 B H D x the
    (row, key) pairs the mask keeps a layer, backward twice that."""
    attn = 4 * batch * cfg.n_heads * cfg.resolved_head_dim * \
        _causal_pairs(seq, seq) * cfg.n_layers
    return 6.0 * n_params * batch * seq + 3.0 * attn


def _first_step(cfg, state, batch, checks: Checks) -> dict:
    """The run's first step against the plain attention path, on the same
    state and batch: float32 compute (flash's tf32x3 forward and
    backward vs the chunked path) loss and grad_norm within
    TRAIN_F32_RTOL; bf16 compute (the run's own path, K5's tensor-core
    variant) by the witness.  The float32 flash step's K5 launches are
    counted (the tf32x3 forward's and backward's path): 2 forwards a
    layer with remat (the recompute), 1 without, and 1 backward."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build
    from repro_torch.train.loop import loss_and_grads
    out, truth = {}, None
    for dtype in ("float32", "bfloat16"):
        for impl in ("xla", "flash"):
            model = build(dataclasses.replace(cfg, attn_impl=impl,
                                              compute_dtype=dtype))
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            metrics, grads = loss_and_grads(state.params, batch, model)
            torch.cuda.synchronize()
            if dtype == "float32" and impl == "flash":
                out["float32_flash_launches"] = _k5_moved({}, launch_counts())
            row = {"loss": float(metrics["loss"]),
                   "grad_norm": _grad_norm(grads),
                   "s": time.perf_counter() - t0}
            if truth is None:
                truth = grads
            else:
                row["grad_rms_vs_float32_plain"] = _grads_rms(grads, truth)
            out[f"{dtype}_{impl}"] = row
            del grads
    torch.cuda.synchronize()
    moved = out["float32_flash_launches"]
    fwd = (2 if cfg.remat else 1) * cfg.n_layers
    checks.expect(moved.get("flash_attention") == fwd and
                  moved.get("flash_attention_tf32x3") == fwd and
                  moved.get("flash_attention_wgmma", 0) == 0 and
                  moved.get("flash_attention_bwd") == cfg.n_layers and
                  moved.get("flash_attention_bwd_tf32x3") == cfg.n_layers,
                  f"train first step, float32 flash: K5 launches {moved}, "
                  f"expected {fwd} forward and {cfg.n_layers} backward, "
                  f"all tf32x3")
    f, p = out["float32_flash"], out["float32_xla"]
    for key in ("loss", "grad_norm"):
        rel = abs(f[key] - p[key]) / abs(p[key])
        out[f"float32_{key}_rel"] = rel
        checks.expect(rel <= TRAIN_F32_RTOL,
                      f"train first step, float32 flash vs plain {key}: "
                      f"{f[key]!r} vs {p[key]!r} ({rel:.2e} > "
                      f"{TRAIN_F32_RTOL})")
    bf, bp = out["bfloat16_flash"], out["bfloat16_xla"]
    out["bf16_ratio"] = (bf["grad_rms_vs_float32_plain"] /
                         bp["grad_rms_vs_float32_plain"])
    checks.expect(out["bf16_ratio"] <= TRAIN_BF16_RATIO,
                  f"train first step: bf16 flash gradient further from "
                  f"float32 than the plain path's: {out}")
    return out


def _bwd_launches_ok(counted: dict, want: int) -> bool:
    """K5's backward launched ``want`` times, every one on wgmma."""
    return (counted.get("flash_attention_bwd") == want and
            counted.get("flash_attention_bwd_wgmma") == want and
            counted.get("flash_attention_bwd_tf32x3", 0) == 0)


def _train_bwd_kernels(cfg) -> int:
    """Kernels one K5 backward launches at the train shape: delta, dK/dV
    and dQ, and the partials' sum where the dK/dV pass is split."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    splits = kernel.dkv_splits(
        TRAIN_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
        TRAIN_SEQ, TRAIN_SEQ, cfg.resolved_head_dim,
        torch.cuda.get_device_properties(0).multi_processor_count)
    return 3 + (splits > 1)


def _traced_step(cfg, state, batch, run, checks: Checks) -> dict:
    """One whole train step, counted and traced: K5's launches by the
    counters and by the kernels the trace holds (every forward the
    tensor-core variant, 2 a layer with the remat recompute; every
    backward the tensor-core variant, one a layer, its three kernels and
    the partials' sum where the dK/dV pass is split), the step's device
    time and the forward's and backward's shares."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build
    from repro_torch.train.loop import make_train_step
    step = make_train_step(build(cfg), run)
    torch.cuda.synchronize()
    reset_launch_counts()
    step(state, batch)                        # counted, and warms the trace
    torch.cuda.synchronize()
    counted = _k5_moved({}, launch_counts())
    want, layers = 2 * cfg.n_layers, cfg.n_layers
    checks.expect(counted.get("flash_attention") == want and
                  counted.get("flash_attention_wgmma") == want and
                  counted.get("flash_attention_tf32x3") == 0 and
                  _bwd_launches_ok(counted, layers),
                  f"train step: K5 launches {counted}, expected {want} "
                  f"forward and {layers} backward, all wgmma")
    prof = _profile(lambda: step(state, batch), 1, watch="flash")
    each = prof.pop("flash_ms_each")
    traced = prof["flash_launches_per_step"]
    # the trace's names: tc::flash_wgmma_kernel<D> (forward);
    # simt::flash_bwd_prep_kernel, tc::flash_bwd_dkv_kernel<D>,
    # simt::flash_bwd_reduce_kernel<T> (a split dK/dV pass) and
    # tc::flash_bwd_dq_kernel<D> (backward); tf32x3::flash_fwd_kernel
    # and tf32x3::flash_bwd_{dkv,dq}_kernel, the other variants
    names = prof.pop("flash_kernels")
    by_ms = prof.pop("flash_ms_by_kernel")

    def count(part):
        return sum(n for name, n in names.items() if part in name)

    def ms(part):
        return sum(t for name, t in by_ms.items() if part in name)

    wgmma = count("flash_wgmma")
    per_bwd = _train_bwd_kernels(cfg)
    bwd = {part: count(f"flash_bwd_{part}_kernel")
           for part in ("prep", "dkv", "reduce", "dq")}
    checks.expect(traced == want + per_bwd * layers and wgmma == want and
                  all(n == (layers if part != "reduce" or per_bwd == 4
                            else 0) for part, n in bwd.items()),
                  f"train step: the trace holds {traced} K5 kernels, "
                  f"{wgmma} of them flash_wgmma, backward {bwd}, expected "
                  f"{want} and {layers} of each ({per_bwd} a backward): "
                  f"{names}")
    device = prof["device_ms_per_step"]
    return {"k5_counted": counted, "k5_traced": traced,
            "k5_traced_wgmma": wgmma, "k5_traced_bwd": bwd,
            "k5_traced_names": names, "k5_traced_ms_by_kernel": by_ms,
            "k5_traced_ms_mean": sum(each) / max(len(each), 1),
            "k5_ms_per_step": prof["flash_ms_per_step"],
            "k5_share_of_device": prof["flash_ms_per_step"] / device,
            "k5_fwd_ms_per_step": ms("flash_wgmma"),
            "k5_bwd_ms_per_step": ms("flash_bwd"),
            "k5_bwd_ms_per_step_by_kernel": {
                part: ms(f"flash_bwd_{part}_kernel")
                for part in ("prep", "dkv", "reduce", "dq")},
            "k5_bwd_share_of_device": ms("flash_bwd") / device,
            "k5_bwd_ms_each": ms("flash_bwd") / layers,
            "profile_step": prof}


def phase_train(seed: int) -> dict:
    """qwen2-1.5b at its published widths and depth (float32 parameters,
    bf16 compute, remat, flash attention) trained TRAIN_STEPS steps of
    4 x 2,048 tokens through ``repro_torch.launch.train.train`` with a
    checkpoint every TRAIN_CKPT_EVERY, then resumed from the step-4
    checkpoint to step 8: the resumed losses equal the uninterrupted
    run's bit for bit.  Before it, its first step held against the plain
    attention path and one step counted and traced.  Every check runs
    before the phase fails on any."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.models import build
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.loop import init_state
    cfg = dataclasses.replace(qwen2_1_5b.config(), attn_impl="flash")
    shape = ShapeConfig("chip_smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    run = RunConfig(total_steps=TRAIN_STEPS, warmup_steps=1, seed=seed,
                    checkpoint_every=TRAIN_CKPT_EVERY, checkpoint_dir=ckpt,
                    log_every=1)
    checks = Checks()
    out = {"arch": cfg.arch_id, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": f"{cfg.n_heads}/{cfg.n_kv_heads}",
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "remat": cfg.remat, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "checkpoint_every": TRAIN_CKPT_EVERY,
           "disk_free_gb": shutil.disk_usage(ckpt).free / 1e9}
    try:
        _free()
        t0 = time.perf_counter()
        state = init_state(build(cfg), seed, DEVICE)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tree_leaves(state.params))
        out["params"] = n_params
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in make_batch(cfg, shape, 0, seed).items()}
        t0 = time.perf_counter()
        out["first_step"] = _first_step(cfg, state, batch, checks)
        out["first_step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out.update(_traced_step(cfg, state, batch, run, checks))
        out["traced_step_s"] = time.perf_counter() - t0
        out["checks_peak_gb"] = _peak_gb()
        del state, batch
        _free()

        reset_launch_counts()
        t0 = time.perf_counter()
        full = train(cfg, shape, run, log=log)
        out["run_s"] = time.perf_counter() - t0
        out["run_launches"] = _k5_moved({}, launch_counts())
        out["peak_gb"] = _peak_gb()
        steps = sorted(n for n in os.listdir(ckpt) if n.startswith("step_"))
        out["checkpoints"] = steps
        # the crash: the step-8 checkpoint never landed; resume from 4
        shutil.rmtree(os.path.join(ckpt, f"step_{TRAIN_STEPS:08d}"))
        _free()
        reset_launch_counts()
        t0 = time.perf_counter()
        resumed = train(cfg, shape, run, log=log)
        out["resume_s"] = time.perf_counter() - t0
        out["resume_launches"] = _k5_moved({}, launch_counts())
        out["resume_peak_gb"] = _peak_gb()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = full["losses"]
    out.update({"losses": losses, "step_s": full["step_s"],
                "save_s": full["save_s"], "health": full["health"],
                "resumed_losses": resumed["losses"],
                "resumed_start": resumed["start_step"],
                "resumed_step_s": resumed["step_s"],
                "resumed_save_s": resumed["save_s"]})
    step_s = float(np.median(full["step_s"][1:]))
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    out.update({"step_s_median": step_s,
                "tokens_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
                "model_flops": flops,
                "bf16_peak_share": flops / (step_s * BF16_TC_OPS_PER_S),
                "device_ms_per_step":
                    out["profile_step"]["device_ms_per_step"],
                "device_busy_share":
                    out["profile_step"]["device_ms_per_step"] /
                    (step_s * 1e3)})
    want = {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_wgmma": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_tf32x3": 0,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd_wgmma": cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd_tf32x3": 0}
    checks.expect(out["run_launches"] == want,
                  f"train run: K5 launches {out['run_launches']}, "
                  f"expected {want}")
    checks.expect(len(losses) == TRAIN_STEPS and
                  all(math.isfinite(x) for x in losses),
                  f"train run: losses {losses}")
    checks.expect(losses[0] == out["first_step"]["bfloat16_flash"]["loss"],
                  f"train run: first loss {losses[0]!r} is not the first "
                  f"step's {out['first_step']['bfloat16_flash']['loss']!r}")
    checks.expect(out["checkpoints"] == [f"step_{TRAIN_CKPT_EVERY:08d}",
                                         f"step_{TRAIN_STEPS:08d}"],
                  f"train run: checkpoints {out['checkpoints']}")
    checks.expect(resumed["start_step"] == TRAIN_CKPT_EVERY and
                  resumed["losses"] == losses[TRAIN_CKPT_EVERY:],
                  f"resumed run from step {resumed['start_step']}: losses "
                  f"{resumed['losses']} vs {losses[TRAIN_CKPT_EVERY:]}")
    out["failures"] = checks.failures
    log("train: " + json.dumps(out))
    checks.raise_any()
    return out


# ---------------------------------------------------------------------------
# distcalc: the Distributed Data Calculator's predictions against the run
# ---------------------------------------------------------------------------
#: remat-off what-if: steps timed (the first warms, the rest are timed)
WHATIF_STEPS = 3
#: configs one card cannot hold, and those the families phase runs
NOT_ON_ONE_CARD = ("phi3.5-moe-42b-a6.6b", "qwen1.5-32b", "llama3-405b")
ON_ONE_CARD = ("qwen2-1.5b", "granite-moe-1b-a400m", "zamba2-1.2b",
               "xlstm-350m", "seamless-m4t-large-v2", "pixtral-12b")


def _distcalc_cells(report) -> list:
    """(cell, arch, shape, strategy, measured seconds) for every cell the
    run measured: the train step with its own strategy; each prefill or
    forward and each decode step (measured: the decode loop's seconds
    over its steps) with the one-card serving strategy (``ep`` on a MoE,
    as the reference's candidates set it).  Without a report (``--only
    dryrun``) every measured value is None."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import distcalc as D

    def serve(arch):
        return D.Strategy(tp=1, fsdp=False, ep=bool(get_config(arch).moe),
                          remat=False)

    def shape(seq, kind, batch=FAM_BATCH):
        return ShapeConfig(kind, seq, batch, kind)

    def measured(fn):
        return fn() if report else None

    tr, lm, fam = (report or {}).get("train"), (report or {}).get("lm"), \
        (report or {}).get("families")
    cells = [("train step", "qwen2-1.5b", shape(TRAIN_SEQ, "train",
                                                TRAIN_BATCH),
              D.Strategy(tp=1, fsdp=False, ep=False, remat=True),
              measured(lambda: tr["step_s_median"])),
             ("lm prefill", "qwen2-1.5b", shape(LM_PROMPT, "prefill",
                                                LM_BATCH),
              serve("qwen2-1.5b"), measured(lambda: lm["prefill_s"])),
             ("lm decode step", "qwen2-1.5b",
              shape(LM_PROMPT + LM_DECODE, "decode", LM_BATCH),
              serve("qwen2-1.5b"),
              measured(lambda: lm["decode_s"] / LM_DECODE))]
    for arch in ("granite-moe-1b-a400m", "pixtral-12b"):
        cells += [(f"{arch} prefill", arch, shape(FAM_SEQ, "prefill"),
                   serve(arch), measured(lambda: fam[arch]["prefill_s"])),
                  (f"{arch} decode step", arch,
                   shape(FAM_SEQ + FAM_DECODE, "decode"), serve(arch),
                   measured(lambda: fam[arch]["decode_s"] / FAM_DECODE))]
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        cells += [(f"{arch} forward", arch, shape(FAM_SEQ, "prefill"),
                   serve(arch), measured(lambda: fam[arch]["forward_s"])),
                  (f"{arch} decode step", arch,
                   shape(STEP_PROMPT + STEP_DECODE, "decode"), serve(arch),
                   measured(lambda: fam[arch]["served"]["decode_s"] /
                            STEP_DECODE))]
    sm = "seamless-m4t-large-v2"
    # distcalc sizes an encoder-decoder's source as its target: the
    # forward is predicted at the 512 targets (the run encodes 1,024)
    cells += [("seamless-m4t-large-v2 forward", "seamless-m4t-large-v2",
               shape(TGT_LEN, "prefill"), serve("seamless-m4t-large-v2"),
               measured(lambda: fam[sm]["forward_s"])),
              ("seamless-m4t-large-v2 decode step", "seamless-m4t-large-v2",
               shape(STEP_DECODE + 1, "decode"),
               serve("seamless-m4t-large-v2"),
               measured(lambda: fam[sm]["decode_s"] / STEP_DECODE))]
    return cells


def _remat_off_steps(seed: int, checks: Checks) -> dict:
    """qwen2-1.5b at full width and depth, ``remat=False`` (what
    ``complete_strategy`` picks), WHATIF_STEPS steps of the train phase's
    batches through ``train_step``, no checkpoints: the steps' host
    seconds, losses, peak memory and K5's launches (one a layer a step,
    all on ``wgmma``).  Running out of memory is the finding that the
    reference's ``fits_memory`` is wrong for the card, not a failure."""
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build
    from repro_torch.train.loop import init_state, make_train_step
    cfg = dataclasses.replace(qwen2_1_5b.config(), attn_impl="flash",
                              remat=False)
    shape = ShapeConfig("chip_smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    model = build(cfg)
    step = make_train_step(model, RunConfig(total_steps=TRAIN_STEPS,
                                            warmup_steps=1, seed=seed))
    out = {"remat": False, "steps": WHATIF_STEPS}
    _free()
    state = None
    try:
        state = init_state(model, seed, DEVICE)
        step_s, losses = [], []
        reset_launch_counts()
        for i in range(WHATIF_STEPS):
            batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
                     make_batch(cfg, shape, i, seed).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
        out["k5_launches"] = _k5_moved({}, launch_counts())
        out["step_s"] = step_s
        out["step_s_median"] = float(np.median(step_s[1:]))
        out["losses"] = losses
        out["fits"] = True
    except torch.cuda.OutOfMemoryError as exc:
        out["fits"] = False
        out["oom"] = str(exc).splitlines()[0]
        log("distcalc FINDING: qwen2-1.5b's train step with remat off "
            f"does not fit the card, though fits_memory says it does: "
            f"{out['oom']}")
    finally:
        out["peak_gb"] = _peak_gb()
        del state
        _free()
    if out["fits"]:
        want = cfg.n_layers * WHATIF_STEPS
        k5 = out["k5_launches"]
        checks.expect(k5.get("flash_attention") == want and
                      k5.get("flash_attention_wgmma") == want and
                      k5.get("flash_attention_tf32x3") == 0 and
                      _bwd_launches_ok(k5, want),
                      f"remat-off steps: K5 launches {k5}, expected {want} "
                      f"forward and {want} backward, all wgmma")
        checks.expect(all(math.isfinite(x) for x in out["losses"]),
                      f"remat-off steps: losses {out['losses']}")
    return out


def phase_distcalc(seed: int, report: dict) -> dict:
    """``repro_torch.core.distcalc`` on ``H100_SXM`` and a one-chip
    ``MeshSpec(1, 1, 1)``: every cell the run measured predicted (three
    roofline terms, the dominant one) beside its measured seconds and
    their ratio; a measured time under its prediction is recorded as a
    distcalc overcount, not gated.  Then the what-if ``complete_strategy``
    answers for the train cell (remat off) run on the card, and whether
    the card orders the two strategies as predicted.  Checks: every
    prediction finite and positive, ``step_seconds`` the largest term,
    the chosen strategy valid and fitting, and ``fits_memory`` false for
    the three configs one card cannot hold and true for the six the run
    serves or trains (at the families phase's prefill shape)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import distcalc as D
    from repro_torch.core.hardware import H100_SXM
    one = D.MeshSpec(1, 1, 1)
    checks = Checks()
    rows = []
    cells = _distcalc_cells(report)
    for name, arch, shape, strat, measured in cells:
        cfg = get_config(arch)
        t = D.synthesize(cfg, shape, one, strat, H100_SXM)
        row = dict(cell=name, arch=arch, seq=shape.seq_len,
                   batch=shape.global_batch, kind=shape.kind,
                   strategy=strat.describe(), **t.to_json(),
                   measured_s=measured,
                   measured_over_predicted=measured / t.step_seconds,
                   overcount=measured < t.step_seconds)
        rows.append(row)
        terms = (t.compute_s, t.memory_s, t.collective_s)
        checks.expect(all(math.isfinite(x) and x >= 0 for x in terms) and
                      t.step_seconds > 0 and
                      t.step_seconds == max(terms),
                      f"distcalc {name}: terms {terms}, step "
                      f"{t.step_seconds}")
        log(f"distcalc {name} ({strat.describe()}): compute "
            f"{t.compute_s * 1e3:.3f} ms, memory {t.memory_s * 1e3:.3f} ms, "
            f"collective {t.collective_s * 1e3:.3f} ms, {t.dominant}-bound; "
            f"predicted {t.step_seconds * 1e3:.3f} ms, measured "
            f"{measured * 1e3:.3f} ms, ratio {measured / t.step_seconds:.3f}"
            + (" (measured under the prediction: a distcalc overcount)"
               if measured < t.step_seconds else ""))
    train_cell = cells[0]
    cfg, shape = get_config(train_cell[1]), train_cell[2]
    best, best_t = D.complete_strategy(cfg, shape, one, tpu=H100_SXM)
    run_t = D.synthesize(cfg, shape, one, train_cell[3], H100_SXM)
    checks.expect(not D.invalid_reasons(cfg, shape, one, best) and
                  D.fits_memory(cfg, shape, one, best, H100_SXM),
                  f"distcalc: complete_strategy chose {best}, invalid or "
                  f"not fitting")
    # the families phase's prefill (4 x 2,048) with the serving strategy
    serve_shape = dataclasses.replace(shape, kind="prefill")
    fits = {arch: D.fits_memory(get_config(arch), serve_shape, one,
                                D.Strategy(tp=1, fsdp=False,
                                           ep=bool(get_config(arch).moe),
                                           remat=False), H100_SXM)
            for arch in NOT_ON_ONE_CARD + ON_ONE_CARD}
    checks.expect(not any(fits[a] for a in NOT_ON_ONE_CARD) and
                  all(fits[a] for a in ON_ONE_CARD),
                  f"distcalc fits_memory on one card: {fits}")
    out = {"profile": H100_SXM.name, "mesh": "MeshSpec(1, 1, 1)",
           "cells": rows, "fits_memory_prefill_4x2048": fits,
           "train_chosen": best.describe(),
           "train_chosen_step_s": best_t.step_seconds,
           "train_run_strategy_step_s": run_t.step_seconds}
    log(f"distcalc what-if: complete_strategy picks {best.describe()} at "
        f"{best_t.step_seconds * 1e3:.3f} ms against the run's "
        f"{train_cell[3].describe()} at {run_t.step_seconds * 1e3:.3f} ms")
    if best.remat != train_cell[3].remat:
        off = _remat_off_steps(seed, checks)
        out["what_if"] = off
        if off["fits"]:
            # the same seed, batches and schedule as the train phase's
            # first steps: remat recomputes the same forward, so the same
            # losses (bit for bit on the card; held at 1e-5 relative)
            want = report["train"]["losses"][:WHATIF_STEPS]
            checks.expect(all(abs(a - b) <= 1e-5 * abs(b) for a, b in
                              zip(off["losses"], want)),
                          f"remat-off losses {off['losses']} are not the "
                          f"train phase's {want}")
            on_s = report["train"]["step_s_median"]
            predicted = best_t.step_seconds < run_t.step_seconds
            measured = off["step_s_median"] < on_s
            off.update(remat_on_step_s=on_s,
                       measured_over_predicted=off["step_s_median"] /
                       best_t.step_seconds,
                       card_agrees_with_predicted_order=(predicted ==
                                                         measured))
            log(f"distcalc what-if on the card: remat off "
                f"{off['step_s_median']:.4f} s a step (remat on "
                f"{on_s:.4f} s), peak {off['peak_gb']:.1f} GB, K5 "
                f"{off['k5_launches']}; the card "
                f"{'agrees with' if predicted == measured else 'reverses'}"
                f" the predicted order")
    out["failures"] = checks.failures
    log("distcalc: " + json.dumps(out))
    checks.raise_any()
    return out


# ---------------------------------------------------------------------------
# dryrun: the dry run's per-chip counts against the run, and at scale
# ---------------------------------------------------------------------------
#: the production cells the dryrun phase counts (train_4k, kernel K5's
#: op for attention), each in a subprocess of its own, all at once: the
#: three configs one card cannot hold on the single-pod (16, 16) fake
#: mesh with probes, and the smallest of them on the multi-pod
#: (2, 16, 16) one.  On meta tensors: no FakeTensorMode dispatch, about
#: half the seconds a count (the FLOPs are the same)
DRYRUN_CELLS = (("phi3.5-moe-42b-a6.6b", "single"),
                ("qwen1.5-32b", "single"), ("llama3-405b", "single"),
                ("phi3.5-moe-42b-a6.6b", "multi"))
DRYRUN_TIMEOUT_S = 600


def _count_cells(report, device: str = DEVICE) -> list:
    """(cell, arch, a builder of its dry-run Cell, strategy, measured
    seconds or None) for every cell the run measured, counted on one
    card's fake tensors of ``device`` at the shapes and with the flash
    attention it ran: the train step, the lm prefill and decode step,
    each family's prefill or forward and decode step (a decode step
    against the cache length it served)."""
    import dataclasses
    import functools
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import distcalc as D
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build
    one = Mesh(("data", "model"), (1, 1))
    measured = {c[0]: (c[3], c[4]) for c in _distcalc_cells(report)} \
        if report else {}

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch), attn_impl="flash")

    def lowered(arch, seq, batch, kind, **kw):
        return functools.partial(dryrun.lower_cell, cfg_of(arch),
                                 ShapeConfig(kind, seq, batch, kind), one,
                                 device=device, **kw)

    def seamless_forward():
        # what the families phase times: the hidden states of 512 target
        # tokens over 1,024 source frames (no unembedding)
        cfg = cfg_of("seamless-m4t-large-v2")
        model, mode = build(cfg), FakeTensorMode()
        meta = model.init(0, device="meta")
        with mode:
            params = dryrun.abstract(meta, device)
            tgt = torch.empty((FAM_BATCH, TGT_LEN), dtype=torch.int32,
                              device=device)
            src = torch.empty((FAM_BATCH, SRC_LEN, cfg.d_model),
                              device=device)

        def run():
            with torch.no_grad():
                return model.forward(params, tgt, embeds=src, hidden=True)

        return dryrun.Cell(run, (params, tgt, src), one, False, True, mode)

    def serve(arch):
        return D.Strategy(tp=1, fsdp=False, ep=bool(get_config(arch).moe),
                          remat=False)

    rows = [("train step", "qwen2-1.5b",
             lowered("qwen2-1.5b", TRAIN_SEQ, TRAIN_BATCH, "train"),
             D.Strategy(tp=1, fsdp=False, ep=False, remat=True)),
            ("lm prefill", "qwen2-1.5b",
             lowered("qwen2-1.5b", LM_PROMPT, LM_BATCH, "prefill"),
             serve("qwen2-1.5b")),
            ("lm decode step", "qwen2-1.5b",
             lowered("qwen2-1.5b", LM_PROMPT + LM_DECODE, LM_BATCH,
                     "decode"), serve("qwen2-1.5b"))]
    for arch in ("granite-moe-1b-a400m", "pixtral-12b"):
        rows += [(f"{arch} prefill", arch,
                  lowered(arch, FAM_SEQ, FAM_BATCH, "prefill"), serve(arch)),
                 (f"{arch} decode step", arch,
                  lowered(arch, FAM_SEQ + FAM_DECODE, FAM_BATCH, "decode"),
                  serve(arch))]
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        rows += [(f"{arch} forward", arch,
                  lowered(arch, FAM_SEQ, FAM_BATCH, "prefill"), serve(arch)),
                 (f"{arch} decode step", arch,
                  lowered(arch, STEP_PROMPT + STEP_DECODE, FAM_BATCH,
                          "decode"), serve(arch))]
    sm = "seamless-m4t-large-v2"
    rows += [(f"{sm} forward", sm, seamless_forward, serve(sm)),
             (f"{sm} decode step", sm,
              lowered(sm, STEP_DECODE + 1, FAM_BATCH, "decode",
                      src_len=SRC_LEN), serve(sm))]
    return [(name, arch, make, strat, measured.get(name, (None, None))[1])
            for name, arch, make, strat in rows]


#: processes counting the measured cells, each cell in one; the xlstm
#: forward's sLSTM loop (~0.5M small ops, ~2 minutes) is taken first
COUNT_WORKERS = 3
SLOWEST_COUNT = "xlstm-350m forward"


def _count_named(name: str, device: str) -> dict:
    """One measured cell's dry-run costs, by name (a worker's task)."""
    from repro_torch.launch import dryrun
    make = next(c[2] for c in _count_cells(None, device) if c[0] == name)
    return dryrun.extract_costs(make())


def _fake_counts(report, checks: Checks, device: str = DEVICE) -> list:
    """Every measured cell counted on one card's fake tensors, in
    COUNT_WORKERS processes: FLOPs, bytes, collective bytes; distcalc's
    predicted FLOPs and terms on H100_SXM; the roofline of the count
    (FLOPs at the bf16 peak, bytes at the HBM rate); the measured
    seconds and the ratios."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import get_config
    from repro_torch.core import distcalc as D
    from repro_torch.core.hardware import H100_SXM
    one = D.MeshSpec(1, 1, 1)
    shapes = {c[0]: c[2] for c in _distcalc_cells(None)}
    cells = _count_cells(report, device)
    with ProcessPoolExecutor(COUNT_WORKERS, mp_context=multiprocessing.
                             get_context("spawn")) as pool:
        counted = {c[0]: pool.submit(_count_named, c[0], device)
                   for c in sorted(cells, key=lambda c: c[0] !=
                                   SLOWEST_COUNT)}
        costs = {name: f.result() for name, f in counted.items()}
    out = []
    for name, arch, _, strat, measured in cells:
        c = costs[name]
        t = D.synthesize(get_config(arch), shapes[name], one, strat,
                         H100_SXM)
        compute_s = c["flops"] / BF16_TC_OPS_PER_S
        memory_s = c["bytes_accessed"] / HBM_BYTES_PER_S
        bound = max(compute_s, memory_s)
        row = {"cell": name, "arch": arch, "count_s": c["seconds"],
               "flops": c["flops"], "bytes": c["bytes_accessed"],
               "collective_bytes":
                   c["collectives"]["moved_bytes_per_chip"],
               "k5_flops_formula": True,
               "predicted_flops": t.flops_per_chip,
               "predicted": t.to_json(), "strategy": strat.describe(),
               "count_compute_s": compute_s, "count_memory_s": memory_s,
               "count_bound_s": bound,
               "count_bound_by": "compute" if compute_s >= memory_s
               else "memory",
               "flops_over_predicted": c["flops"] / t.flops_per_chip,
               "measured_s": measured}
        if measured is not None:
            row["measured_over_count_bound"] = measured / bound
            row["measured_over_predicted"] = measured / t.step_seconds
        checks.expect(c["flops"] > 0 and math.isfinite(c["bytes_accessed"])
                      and c["collectives"]["moved_bytes_per_chip"] == 0,
                      f"dryrun count of {name}: {c}")
        out.append(row)
        log(f"dryrun count {name}: {c['flops']:.4e} FLOPs "
            f"({row['flops_over_predicted']:.3f}x distcalc's "
            f"{t.flops_per_chip:.4e}), {c['bytes_accessed']:.4e} bytes, "
            f"collective {row['collective_bytes']:.4e} B; H100 roofline "
            f"of the count {bound * 1e3:.3f} ms ({row['count_bound_by']}),"
            f" distcalc {t.step_seconds * 1e3:.3f} ms ({t.dominant}); "
            + (f"measured {measured * 1e3:.3f} ms: "
               f"{row['measured_over_count_bound']:.3f}x the count's "
               f"roofline, {row['measured_over_predicted']:.3f}x distcalc's"
               if measured is not None else "not measured in this run")
            + f"; counted in {c['seconds']:.2f} s")
    return out


def _real_step_count(seed: int, fake_flops: float, checks: Checks) -> dict:
    """One real qwen2-1.5b train step (4 x 2,048, bf16, flash, remat) on
    the card under the dry run's counter: its FLOPs equal the fake count
    exactly, K5's 56 launches and its backward's 28 counted through their
    ops' flop formulas."""
    import dataclasses
    import torch
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.train.loop import init_state, make_train_step
    cfg = dataclasses.replace(qwen2_1_5b.config(), attn_impl="flash")
    shape = ShapeConfig("chip_smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    model = build(cfg)
    _free()
    state = init_state(model, seed, DEVICE)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in make_batch(cfg, shape, 0, seed).items()}
    step = make_train_step(model, RunConfig())
    torch.cuda.synchronize()
    reset_launch_counts()
    counter = dryrun.CostCounter()
    t0 = time.perf_counter()
    with counter:
        _, metrics = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k5 = _k5_moved({}, launch_counts())
    loss = float(metrics["loss"])
    del state, batch, metrics
    _free()
    costs = counter.costs()
    want = 2 * cfg.n_layers
    out = {"flops": costs["flops"], "fake_flops": fake_flops,
           "bytes": costs["bytes_accessed"], "local_ops": costs["local_ops"],
           "k5_launches": k5, "loss": loss, "counted_step_s": seconds}
    checks.expect(costs["flops"] == fake_flops,
                  f"dryrun: the real train step counts {costs['flops']!r} "
                  f"FLOPs, the fake count {fake_flops!r}")
    checks.expect(k5.get("flash_attention") == want and
                  k5.get("flash_attention_wgmma") == want and
                  _bwd_launches_ok(k5, cfg.n_layers),
                  f"dryrun: the counted real step launched K5 {k5}, "
                  f"expected {want} forward and {cfg.n_layers} backward on "
                  f"wgmma")
    checks.expect(math.isfinite(loss), f"dryrun: real step loss {loss}")
    log(f"dryrun real train step on the card: {costs['flops']:.6e} FLOPs "
        f"counted, the fake count {fake_flops:.6e} "
        f"({'equal' if costs['flops'] == fake_flops else 'DIFFERENT'}), "
        f"K5 {k5}, {seconds:.2f} s under the counter")
    return out


def _start_production_cells():
    """The DRYRUN_CELLS started through ``python -m
    repro_torch.launch.dryrun``, one subprocess a cell, all at once, on
    meta tensors: (their records' directory, the processes)."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", "train_4k", "--mesh", mesh, "--attn-impl",
               "flash", "--device", "meta", "--out-dir", out_dir]
        procs.append((arch, mesh, time.perf_counter(), subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    return out_dir, procs


def _production_cells(started, checks: Checks) -> list:
    """Waits for the production cells' subprocesses (a failed one fails
    the phase; one still running at DRYRUN_TIMEOUT_S is killed and
    fails it) and reads their records: one line a cell."""
    out_dir, procs = started
    rows = []
    for arch, mesh, t0, proc in procs:
        try:
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            checks.expect(False, f"dryrun {arch} {mesh}: exit "
                                 f"{proc.returncode}: {err[-3000:]}")
            continue
        with open(os.path.join(out_dir, f"{arch}__train_4k__{mesh}.json")
                  ) as fh:
            rec = json.load(fh)
        keys = ("full", "distcalc", "roofline") + (
            ("probes", "extrapolated") if mesh == "single" else ())
        checks.expect(all(k in rec for k in keys),
                      f"dryrun {arch} {mesh}: record keys {sorted(rec)}")
        full = rec["full"]
        row = {"arch": arch, "mesh": mesh, "collected_s": wall,
               "count_s": rec["compile_seconds"],
               "cell_s": rec["seconds"],
               "microbatch": rec.get("microbatch"),
               "n_microbatches": rec.get("n_microbatches"),
               "flops": full["flops"], "bytes": full["bytes_accessed"],
               "collective_bytes":
                   full["collectives"]["moved_bytes_per_chip"],
               "collectives": full["collectives"]["per_kind_result_bytes"],
               "memory": full["memory"],
               "extrapolated": rec.get("extrapolated"),
               "roofline_h100": rec["roofline"],
               "roofline_tpu_v5e": rec["roofline_tpu_v5e"],
               "distcalc_h100": rec["distcalc"],
               "distcalc_tpu_v5e": rec["distcalc_tpu_v5e"]}
        rows.append(row)
        h, v, dc = rec["roofline"], rec["roofline_tpu_v5e"], rec["distcalc"]
        log(f"dryrun {arch} train_4k {mesh}: full count "
            f"{rec['compile_seconds']:.1f} s, the cell {rec['seconds']:.1f}"
            f" s (collected at {wall:.1f} s), "
            f"microbatch {row['microbatch']} x {row['n_microbatches']}; per "
            f"chip {full['flops']:.4e} FLOPs, {full['bytes_accessed']:.4e} "
            f"bytes, {row['collective_bytes']:.4e} collective bytes, "
            f"arguments {full['memory']['argument_size_in_bytes'] / 1e9:.2f}"
            f" GB; H100_SXM compute/memory/collective {h['compute_s']:.3f}/"
            f"{h['memory_s']:.3f}/{h['collective_s']:.3f} s, TPU_V5E "
            f"{v['compute_s']:.3f}/{v['memory_s']:.3f}/"
            f"{v['collective_s']:.3f} s; distcalc ({dc['strategy']}) "
            f"{dc['compute_s']:.3f}/{dc['memory_s']:.3f}/"
            f"{dc['collective_s']:.3f} s; useful_flops_ratio "
            f"{h['useful_flops_ratio']:.4f}")
    return rows


def phase_dryrun(seed: int, report) -> dict:
    """``repro_torch.launch.dryrun`` on the card: every measured cell
    counted on one card's fake CUDA tensors beside distcalc's prediction
    and the run's time; one real train step counted under the same
    counter, its FLOPs the fake count's exactly; the production cells on
    their fake meshes, in subprocesses started first, which run while
    this process counts.  Every check runs before the phase fails on
    any."""
    checks = Checks()
    t0 = time.perf_counter()
    started = _start_production_cells()
    try:
        counts = _fake_counts(report, checks)
        counts_s = time.perf_counter() - t0
        train_flops = next(r["flops"] for r in counts if r["cell"] ==
                           "train step")
        t1 = time.perf_counter()
        real = _real_step_count(seed, train_flops, checks)
        real_s = time.perf_counter() - t1
    except BaseException:
        for *_, proc in started[1]:      # none outlives a failed phase
            proc.kill()
            proc.communicate()
        raise
    production = _production_cells(started, checks)
    production_s = time.perf_counter() - t0
    out = {"counts": counts, "counts_s": counts_s, "real_step": real,
           "real_step_s": real_s, "production": production,
           "production_s": production_s, "failures": checks.failures}
    log("dryrun: " + json.dumps(out, default=str))
    checks.raise_any()
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
    maximum and equal to the dtype's maximum; for float32 the infinities,
    both zeros and NaN queries."""
    cases = []
    for dtype in (np.int32, np.int64, np.float32):
        info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
        extremes = [info.min, info.max, -1, 0]
        if dtype == np.float32:
            # NaN ranks 0: it compares false with every key
            extremes += [-np.inf, np.inf, -0.0, 0.0, np.nan, -np.nan]
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

    nan_queries = 0
    for k, v, qq in _k1_cases(rng, tree_depth):
        if qq.dtype == np.float32:
            nan_queries += 2 * int(np.isnan(qq).sum())
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
                 "nan_queries_checked": nan_queries,
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
    # 10 calls traced: a lone 3-microsecond kernel can miss a trace of
    # one, and now and then the profiler hands back a trace with no
    # device event at all (the counters still saw every launch): that
    # trace is taken again, at most twice
    for attempt in range(1, 4):
        trace = _profile(op, 10)
        if trace["device_events_per_step"] > 0:
            break
    return {"op_trace_attempts": attempt,
            "op_ms": device_ms, "op_host_us_per_call": host_us,
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


#: K5 at each family's shapes (the full configs): name, B, H, KH, Sq,
#: Skv, D, causal, dtype.  bf16 is the served path's; pixtral's float32
#: row is the float32-compute witness's (the tf32x3 forward at D 160)
K5_FAMILY_SHAPES = [
    ("granite-moe prefill", 4, 16, 8, 2048, 2048, 64, True, "bfloat16"),
    ("zamba2 shared attention", 4, 32, 32, 2048, 2048, 64, True, "bfloat16"),
    ("seamless encoder", 4, 16, 16, 1024, 1024, 64, False, "bfloat16"),
    ("seamless decoder self", 4, 16, 16, 512, 512, 64, True, "bfloat16"),
    ("seamless cross", 4, 16, 16, 512, 1024, 64, False, "bfloat16"),
    ("pixtral prefill", 4, 32, 8, 2048, 2048, 160, True, "bfloat16"),
    ("pixtral prefill float32", 4, 32, 8, 2048, 2048, 160, True, "float32"),
]


#: the families' bf16 shapes (the K5 row's)
K5_BF16_SHAPES = [row for row in K5_FAMILY_SHAPES if row[-1] == "bfloat16"]
#: the float32 forward (tf32x3) at every float32 shape the card runs:
#: qwen2-1.5b's prefill and its training attention (the lm phase's and
#: the train phase's float32 checks), then every family's shape in float32
#: (each family's float32 flash witness)
K5_F32_SHAPES = [("qwen2-1.5b float32", LM_BATCH, 12, 2, LM_PROMPT,
                  LM_PROMPT, 128, True, "float32")] + [
    (f"{name} float32", *dims, "float32") for name, *dims, _ in K5_BF16_SHAPES]


def k5_family_cases(gen, shapes=K5_FAMILY_SHAPES) -> list:
    """K5 against its plain version at each family's shape: error (bf16
    within 1e-4 + 2^-8 |ref|, float32 within 1e-5 + 1e-5 |ref|), time,
    bound (4 B H D x the pairs the mask keeps, at the peak of the inputs'
    type: bf16 on the tensor cores, whichever variant runs; float32 off
    them, and for float32 also at 3x the dense TF32 rate, the tf32x3
    kernel's own arithmetic), the plain version's time and SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rows = []
    for name, b, h, kh, sq, skv, d, causal, dtype in shapes:
        dtype = getattr(torch, dtype)
        q, k, v = _k5_inputs(gen, b, h, kh, sq, skv, d, dtype)
        kind = kernel.variant(q.dtype, d)
        rtol, atol = (2.0 ** -8, 1e-4) if dtype == torch.bfloat16 else \
            (1e-5, 1e-5)
        before = launch_counts()
        got = kernel.flash_attention_kernel(q, k, v, causal)[0].float()
        moved = _k5_moved(before, launch_counts())
        assert moved.get("flash_attention") == 1 and \
            moved.get(f"flash_attention_{kind}") == 1, (name, moved)
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        err = (got - want).abs()
        max_err = float(err.max())
        assert bool((err <= atol + rtol * want.abs()).all()), \
            f"K5 ({kind}) vs plain at {name}: max abs {max_err:.3e}"
        del got, want, err
        ms = timed_ms(lambda: kernel.flash_attention_kernel(q, k, v, causal),
                      reps=10)
        plain_ms = timed_ms(lambda: attention_ref(q, k, v, causal=causal),
                            reps=3, warmup=1)
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        try:
            library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=causal, enable_gqa=True), reps=10)
        except RuntimeError as exc:       # no SDPA backend for the shape
            library_ms = None
            log(f"K5 {name}: SDPA refused the shape: {exc}")
        pairs = _causal_pairs(sq, skv) if causal else sq * skv
        n_ops = 4 * b * h * d * pairs
        n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        peak = "bf16_tensor" if q.dtype == torch.bfloat16 else "fp32"
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAKS[peak] * 1e3
        rows.append({"shape": name, "b": b, "heads": f"{h}/{kh}", "sq": sq,
                     "skv": skv, "d": d, "causal": causal,
                     "dtype": str(dtype).removeprefix("torch."),
                     "variant": kind,
                     "max_abs_err": max_err,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "ops_peak": peak, "tflops": n_ops / (ms * 1e-3) / 1e12,
                     "bytes": n_bytes, "ops": n_ops})
        if dtype == torch.float32:
            rows[-1]["bound_tf32x3_ms"] = max(
                t_bytes, 3 * n_ops / TF32_TC_OPS_PER_S * 1e3)
        log(f"K5 {name}: {json.dumps(rows[-1])}")
        del q, k, v, qc, kc, vc
    return rows


#: K5's backward: the train step's shape (bf16, and float32 as the first
#: step's float32 check runs it, on the tf32x3 variant), then every
#: family's K5 shape; the first two rows are the kernels line's
K5_BWD_SHAPES = [
    ("qwen2-1.5b train", TRAIN_BATCH, 12, 2, TRAIN_SEQ, TRAIN_SEQ, 128, True,
     "bfloat16"),
    ("qwen2-1.5b train float32", TRAIN_BATCH, 12, 2, TRAIN_SEQ, TRAIN_SEQ,
     128, True, "float32"),
] + K5_FAMILY_SHAPES
#: the bf16 backward's witness: each gradient's rms distance from the
#: float32 pullback at most this times SDPA backward's (both round P and dS
#: to bf16 once); float32 within K5_BWD_F32_RMS relative rms
K5_BWD_BF16_RATIO = 1.25
K5_BWD_F32_RMS = 1e-4


def _rel_rms(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want) ** 2).mean().sqrt() /
                 (want ** 2).mean().sqrt())


def k5_backward(gen, shapes=K5_BWD_SHAPES) -> list:
    """K5's backward (``flash_attention_bwd_kernel``) at each of ``shapes``
    on the forward kernel's ``out`` and ``lse`` and a random output
    gradient, all in the model's [B, S, H, D] strides: one launch of its
    variant, two calls bit-equal, and against the float32 pullback
    (``attention_bwd_ref`` on the inputs in float32 with the float32
    ``attention_ref`` output and ``attention_lse_ref``): bf16 by the
    witness against SDPA backward (``enable_gqa``) on the same inputs and
    gradient, float32 within K5_BWD_F32_RMS relative rms (SDPA's float32
    distance recorded beside it).  Timed beside the plain version on the
    card (``attention_bwd_ref`` on the same tensors) and SDPA's backward
    on a retained graph; at the train shape each of the call's kernels
    (delta, dK/dV, the partials' sum where the pass is split, dQ) timed
    by a trace of BWD_TRACE_CALLS calls.  Bound: the function's five
    products, 10 B H D x the kept pairs, at the peak of the inputs' type
    (bf16 tensor cores or float32), or the bytes (q, k, v, out, dout and
    lse read once, dq, dk and dv written once); float32 rows also give
    the five products at 3x the dense TF32 rate (the tf32x3 kernel's own
    arithmetic)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref)
    rows = []
    for name, b, h, kh, sq, skv, d, causal, dtype in shapes:
        dtype = getattr(torch, dtype)
        q, k, v = _k5_inputs(gen, b, h, kh, sq, skv, d, dtype)
        g = torch.randn((b, sq, h, d), generator=gen,
                        device=DEVICE).to(dtype).transpose(1, 2)
        kind = kernel.bwd_variant(dtype, d)
        out, lse = kernel.flash_attention_kernel(q, k, v, causal)
        before = launch_counts()
        got = kernel.flash_attention_bwd_kernel(q, k, v, out, lse, g, causal)
        moved = {n: c for n, c in
                 _k5_moved(before, launch_counts()).items() if c}
        assert moved == {"flash_attention_bwd": 1,
                         f"flash_attention_bwd_{kind}": 1}, (name, moved)
        again = kernel.flash_attention_bwd_kernel(q, k, v, out, lse, g,
                                                  causal)
        bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        f32 = [x.float() for x in (q, k, v)]
        truth = attention_bwd_ref(
            *f32, attention_ref(*f32, causal=causal),
            attention_lse_ref(*f32, causal=causal), g.float(), causal)
        ours = [_rel_rms(x, y) for x, y in zip(got, truth)]
        max_err = max(float((x.float() - y).abs().max())
                      for x, y in zip(got, truth))
        del got
        lib = [x.detach().contiguous().requires_grad_(True)
               for x in (q, k, v)]
        gc_ = g.contiguous()
        ref = F.scaled_dot_product_attention(*lib, is_causal=causal,
                                             enable_gqa=True)
        sdpa = [_rel_rms(x, y) for x, y in zip(
            torch.autograd.grad(ref, lib, gc_, retain_graph=True), truth)]
        library_ms = timed_ms(lambda: torch.autograd.grad(
            ref, lib, gc_, retain_graph=True), reps=10)
        del truth
        _free()
        if dtype == torch.bfloat16:
            ok = all(x <= K5_BWD_BF16_RATIO * y for x, y in zip(ours, sdpa))
        else:
            ok = all(x <= K5_BWD_F32_RMS for x in ours)
        assert ok and bit_equal, \
            f"K5 backward ({kind}) at {name}: rel rms {ours} (SDPA " \
            f"{sdpa}), two calls bit-equal {bit_equal}"
        ms = timed_ms(lambda: kernel.flash_attention_bwd_kernel(
            q, k, v, out, lse, g, causal), reps=10)
        plain_ms = timed_ms(lambda: attention_bwd_ref(
            q, k, v, out, lse, g, causal), reps=3, warmup=1)
        by_kernel = {}
        if name.startswith("qwen2-1.5b train"):
            prof = _profile(lambda: kernel.flash_attention_bwd_kernel(
                q, k, v, out, lse, g, causal), BWD_TRACE_CALLS,
                watch="flash_bwd")
            by_kernel = {
                "ms": prof["flash_bwd_ms_by_kernel"],
                "launches": {n: c / BWD_TRACE_CALLS for n, c in
                             prof["flash_bwd_kernels"].items()}}
        pairs = _causal_pairs(sq, skv) if causal else sq * skv
        n_ops = 10 * b * h * d * pairs
        n_bytes = q.element_size() * 4 * (q.numel() + k.numel()) + \
            lse.numel() * 4
        peak = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAKS[peak] * 1e3
        rows.append({
            "shape": name, "b": b, "heads": f"{h}/{kh}", "sq": sq,
            "skv": skv, "d": d, "causal": causal,
            "dtype": str(dtype).removeprefix("torch."), "variant": kind,
            "max_abs_err": max_err, "grad_rel_rms": ours,
            "sdpa_grad_rel_rms": sdpa, "bit_equal": bit_equal,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ops_peak": peak, "ops": n_ops, "bytes": n_bytes,
            "tflops": n_ops / (ms * 1e-3) / 1e12,
            "kernels": by_kernel})
        if kind == "tf32x3":
            rows[-1]["bound_tf32x3_ms"] = max(
                t_bytes, 3 * n_ops / TF32_TC_OPS_PER_S * 1e3)
            rows[-1]["tf32x3_info"] = kernel.bwd_tf32x3_info(d)
        log(f"K5 backward {name}: {json.dumps(rows[-1])}")
        del q, k, v, g, out, lse, lib, ref
        _free()
    return rows


#: calls of K5's backward the train shape's trace covers
BWD_TRACE_CALLS = 5


def kernel_k5_backward_tf32x3(rows) -> dict:
    """The kernels line's row of K5's tf32x3 backward, from
    :func:`k5_backward`'s float32 train-shape row; its launches are the
    train phase's float32 first step's, filled in after that phase."""
    from repro_torch.kernels.flash_attention import kernel
    main = rows[1]
    assert main["variant"] == "tf32x3", main["variant"]
    row = _row("K5 flash_attention backward (tf32x3)", "cuda",
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/ops.py:66 (_bwd, the "
               "custom VJP's backward; XLA's pullback of attention_ref on "
               "the TPU), float32", 0, main["max_abs_err"], main["ms"],
               main["plain_ms"], main["bytes"], main["ops"],
               main["ops_peak"], main["library_ms"],
               {"shape": f"[{main['b']},12,{main['sq']},128] kv_heads=2 "
                         f"float32 causal, [B,S,H,D] strides",
                "variant": main["variant"],
                "library": "scaled_dot_product_attention backward "
                           "(is_causal=True, enable_gqa=True), float32",
                "bound_tf32x3_ms": main["bound_tf32x3_ms"],
                "tflops": main["tflops"],
                "grad_rel_rms": main["grad_rel_rms"],
                "sdpa_grad_rel_rms": main["sdpa_grad_rel_rms"],
                "kernels": main["kernels"],
                "tf32x3_info": {str(dd): kernel.bwd_tf32x3_info(dd)
                                for dd in (64, 128, 160)}})
    log(f"K5 backward tf32x3_info: {json.dumps(row['tf32x3_info'])}")
    return row


def kernel_k5_backward(rows) -> dict:
    """The kernels line's row of K5's backward, from :func:`k5_backward`'s
    rows (the train shape's first); its launches are the train run's,
    filled in after the train phase."""
    from repro_torch.kernels.flash_attention import kernel
    main = rows[0]
    row = _row("K5 flash_attention backward", "cuda",
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/ops.py:66 (_bwd, the "
               "custom VJP's backward; XLA's pullback of attention_ref on "
               "the TPU)", 0, main["max_abs_err"], main["ms"],
               main["plain_ms"], main["bytes"], main["ops"],
               main["ops_peak"], main["library_ms"],
               {"shape": f"[{main['b']},12,{main['sq']},128] kv_heads=2 "
                         f"bf16 causal, [B,S,H,D] strides",
                "variant": main["variant"],
                "library": "scaled_dot_product_attention backward "
                           "(is_causal=True, enable_gqa=True)",
                "tflops": main["tflops"],
                "grad_rel_rms": main["grad_rel_rms"],
                "sdpa_grad_rel_rms": main["sdpa_grad_rel_rms"],
                "kernels": main["kernels"],
                "wgmma_info": {str(dd): kernel.bwd_wgmma_info(dd)
                               for dd in kernel.WGMMA_HEAD_DIMS},
                "shapes": rows})
    log(f"K5 backward wgmma_info: {json.dumps(row['wgmma_info'])}")
    return row


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
    # held at 2^-8 plus 1e-4; float32 at 1e-5.  bf16 at D 64 / 128 / 160
    # runs the tensor-core variant, the rest the tf32x3 one (also at its
    # edges: one query row, one key, causal Sq > Skv, D 24 and 256)
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
              True) + bf16_tol,
             (_k5_inputs(gen, 2, h, kh, 1, 300, d, torch.float32),
              True) + f32_tol,
             (_k5_inputs(gen, 2, 6, 1, 77, 1, 64, torch.float32),
              False) + f32_tol,
             (_k5_inputs(gen, 1, 4, 1, 300, 130, 160, torch.float32),
              True) + f32_tol,
             (_k5_inputs(gen, 1, 2, 1, 150, 100, 24, torch.float32),
              True) + f32_tol,
             (_k5_inputs(gen, 1, 2, 1, 129, 70, 256, torch.float32),
              True) + f32_tol]
    errs = []
    for (q, k, v), causal, rtol, atol in cases:
        kind = kernel.variant(q.dtype, q.shape[-1])
        before = launch_counts()
        got = kernel.flash_attention_kernel(q, k, v, causal)[0].float()
        after = launch_counts()
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        err = (got - want).abs()
        errs.append(float(err.max()))
        assert bool((err <= atol + rtol * want.abs()).all()), \
            f"K5 ({kind}) vs plain {tuple(q.shape)} causal={causal}: max " \
            f"abs {errs[-1]:.3e}"
        moved = {n: after[n] - before.get(n, 0) for n in after
                 if n.startswith("flash_attention")
                 and not n.startswith("flash_attention_bwd")}
        assert moved == {"flash_attention": 1,
                         f"flash_attention_{kind}": 1,
                         **{f"flash_attention_{o}": 0 for o in
                            kernel.VARIANT_LAUNCHES if o != kind}}, \
            f"K5 {tuple(q.shape)} {q.dtype}: counters moved {moved}"
    # the gradient: forward and backward on K5 (float32: the tf32x3
    # forward and backward), against autograd of attention_ref
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
    # the tensor-core variant's registers a thread (at launch) and shared
    # memory a block, at each head dim it is built for
    wgmma_info = {str(dd): kernel.wgmma_info(dd)
                  for dd in kernel.WGMMA_HEAD_DIMS}
    log(f"K5 wgmma_info: {json.dumps(wgmma_info)}")
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
                 "wgmma_info": wgmma_info,
                 "family_shapes": k5_family_cases(gen, K5_BF16_SHAPES),
                 "library": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True, enable_gqa=True)"})


def kernel_k5_tf32x3(seed) -> dict:
    """The kernels line's row of K5's float32 forward (``tf32x3``), from
    :func:`k5_family_cases` at every float32 shape the card runs
    (K5_F32_SHAPES; qwen2-1.5b's first, the row's own), with the kernel's
    registers, shared memory and local memory (spills) at the buckets the
    float32 paths run; its launches are those paths', filled in after the
    phases that run them."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    rows = k5_family_cases(gen, K5_F32_SHAPES)
    assert all(r["variant"] == "tf32x3" for r in rows), rows
    main = rows[0]
    info = {str(d): kernel.fwd_tf32x3_info(d) for d in (64, 128, 160)}
    log(f"K5 tf32x3_info: {json.dumps(info)}")
    return _row("K5 flash_attention (tf32x3)", "cuda",
                "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:84 "
                "(flash_attention_kernel, _flash_kernel :33), float32",
                0, main["max_abs_err"], main["ms"], main["plain_ms"],
                main["bytes"], main["ops"], "fp32", main["library_ms"],
                {"shape": f"[{main['b']},12,{main['sq']},128] kv_heads=2 "
                          f"float32 causal, [B,S,H,D] strides",
                 "variant": "tf32x3",
                 "library": "scaled_dot_product_attention (is_causal=True, "
                            "enable_gqa=True), float32",
                 "bound_tf32x3_ms": main["bound_tf32x3_ms"],
                 "tflops": main["tflops"], "tf32x3_info": info,
                 "shapes": rows})


#: the MoE combine at granite-moe-1b-a400m's widths (D 1,024, E 32, top-8,
#: capacity factor 1.25) and the prefill cell's batches: 16 prompts of
#: 4,096 and of 512 tokens
MOE_COMBINE_TOKENS = (16 * 4096, 16 * 512)
#: routings timed: router logits drawn plainly (next to no drops: every
#: assignment's row is read), and with a per-expert bias that overloads
#: some experts so that ~40% of assignments find no slot, near the
#: prefill cell's 39-45%
MOE_COMBINE_SKEWS = (("uniform", 0.0), ("skewed", 1.75))


def moe_combine_cases(seed: int) -> list:
    """The MoE combine kernel against its plain version and timed beside
    it and beside the scatter-add it replaced in ``moe_ffn``
    (``combine_scatter``: the gate gather, the bf16 weighting and
    ``index_add_``), on the real router's choices, bf16, at each of
    MOE_COMBINE_TOKENS x MOE_COMBINE_SKEWS; the first case's call traced
    by kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_combine import kernel, ref
    from repro_torch.models import moe as M
    cfg = get_config("granite-moe-1b-a400m")
    d, e, k = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 29)
    rows = []
    for t in MOE_COMBINE_TOKENS:
        for label, skew in MOE_COMBINE_SKEWS:
            logits = (torch.randn((t, e), generator=gen, device=DEVICE) +
                      skew * torch.randn((1, e), generator=gen,
                                         device=DEVICE))
            r = dict(zip(M.ROUTE_KEYS, M._route(logits, cfg)))
            c = r["token_ids"].shape[1]
            out = torch.randn((e, c, d), generator=gen,
                              device=DEVICE).to(torch.bfloat16)
            args = (out, r["combine_w"], r["gate_idx"], r["token_ids"],
                    r["gathered_mask"])
            got = kernel.moe_combine_kernel(*args)
            bit_equal = torch.equal(got, kernel.moe_combine_kernel(*args))
            want = ref.moe_combine_ref(out.float(), *args[1:])
            # one bf16 rounding of the float32 sum, and float32 slack for
            # fused against separate roundings (tests/test_torch_cuda.py)
            scale = ref.moe_combine_ref(out.float().abs(),
                                        r["combine_w"].abs(), *args[2:])
            err = (got.float() - want).abs()
            ok = bool((err <= 2.0 ** -8 * want.abs() +
                       2 * k * 2.0 ** -23 * scale).all())
            assert ok and bit_equal, \
                f"moe_combine at T {t} ({label}): max abs err " \
                f"{float(err.max())}, two calls bit-equal {bit_equal}"
            max_err = float(err.max())
            del got, want, scale, err
            kept = int(r["gathered_mask"].sum())
            n_bytes = kernel.bytes_needed(d, out.dtype, t, k, e * c, kept)
            ms = timed_ms(lambda: kernel.moe_combine_kernel(*args))
            plain_ms = timed_ms(lambda: ref.moe_combine_ref(*args), reps=5,
                                warmup=1)
            scatter_ms = timed_ms(lambda: M.combine_scatter(
                out, r["combine_w"], r["token_ids"], t))
            row = {"case": f"T {t} ({t // 16} x 16), {label} routing",
                   "t": t, "c": c, "kept": kept,
                   "drop_share": 1 - kept / (t * k), "ms": ms,
                   "plain_ms": plain_ms, "index_add_ms": scatter_ms,
                   "bytes": n_bytes,
                   "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                   "roofline": n_bytes / HBM_BYTES_PER_S * 1e3 / ms,
                   "max_abs_err": max_err,
                   "vectors_a_thread": kernel.vectors_a_thread(
                       k, d, out.dtype)}
            if not rows:
                prof = _profile(lambda: kernel.moe_combine_kernel(*args), 5)
                row["traced_ms_by_kernel"] = prof["top_kernels_ms_per_step"]
            log("moe_combine: " + json.dumps(row))
            rows.append(row)
            del out, args, r, logits
            _free()
    return rows


def kernel_moe_combine(seed: int) -> dict:
    """The kernels line's row of the MoE combine, from
    :func:`moe_combine_cases` (the 4,096-token batch with skewed routing,
    the cell's, is the row's own); its launches are the granite family's,
    filled in after the families phase."""
    rows = moe_combine_cases(seed)
    main = rows[1]
    return _row("MoE combine (gather)", "cuda",
                "src/repro_torch/csrc/moe_combine.cu",
                "none: the reference's combine is XLA's .at[].add "
                "(src/repro/models/moe.py:92-95), first ported as a bf16 "
                "index_add_ over every capacity slot",
                0, main["max_abs_err"], main["ms"], main["plain_ms"],
                main["bytes"], 0, "fp32", None,
                {"shape": "granite-moe-1b-a400m: D 1024, E 32, top-8, "
                          "bf16; " + main["case"],
                 "index_add_ms": main["index_add_ms"], "shapes": rows})


def only_k5(seed: int) -> list:
    """``--only k5``: K5 against its plain version, timed beside SDPA, at
    the lm phase's shape and each family's, in bf16 and float32
    (:func:`k5_family_cases`), and
    its backward beside SDPA's at the train shape and each family's
    (:func:`k5_backward`)."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    lm = ("lm prefill", LM_BATCH, 12, 2, LM_PROMPT, LM_PROMPT, 128, True,
          "bfloat16")
    return k5_family_cases(gen, [lm] + K5_BF16_SHAPES + K5_F32_SHAPES) + [
        dict(row, case="backward") for row in k5_backward(gen)]


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
    parser.add_argument("--only", choices=["whatif", "stores", "k5",
                                           "moe_combine", "train",
                                           "dryrun"],
                        default=None,
                        help="whatif: run that phase alone, without the "
                             "check of its launches; stores: time K1 and "
                             "the bloom_probe op at the kvstore shapes; k5: "
                             "time K5 and SDPA at the lm and family shapes; "
                             "moe_combine: time the MoE combine beside its "
                             "plain version and index_add_ at the prefill "
                             "cell's shapes; "
                             "train: the train phase alone; dryrun: "
                             "the dryrun phase alone (no measured times).  "
                             "Each prints its report but no kernels line "
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
    names = {"stores": [n for n in build.SOURCES if n != "flash_attention"],
             "k5": ["flash_attention"],
             "moe_combine": ["moe_combine"],
             "train": ["flash_attention"],
             "dryrun": ["flash_attention"]}.get(args.only,
                                               list(build.SOURCES))
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
    if args.only == "k5":
        report["k5"] = only_k5(args.seed)
        for row in report["k5"]:
            log("k5: " + json.dumps(row))
        _write_report(args.report, report)
        log(_nvidia_smi())
        return 0
    if args.only == "moe_combine":
        report["moe_combine"] = moe_combine_cases(args.seed)
        _write_report(args.report, report)
        log(_nvidia_smi())
        return 0
    if args.only == "train":
        report["train"] = phase_train(args.seed)
        _write_report(args.report, report)
        log(_nvidia_smi())
        return 0
    if args.only == "dryrun":
        t0 = time.perf_counter()
        report["dryrun"] = phase_dryrun(args.seed, None)
        report["dryrun_phase_s"] = time.perf_counter() - t0
        _write_report(args.report, report)
        log(f"dryrun phase {report['dryrun_phase_s']:.1f} s")
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
    bwd_rows = k5_backward(
        torch.Generator(device=DEVICE).manual_seed(args.seed + 6))
    kernels += [kernel_k5_backward(bwd_rows),
                kernel_k5_backward_tf32x3(bwd_rows),
                kernel_k5_tf32x3(args.seed),
                kernel_moe_combine(args.seed)]
    report["kernels_phase_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    report["serving"] = phase_serving(args.seed)
    report["serving"]["phase_s"] = time.perf_counter() - t0
    sv = report["serving"]
    log(f"serving: {SERVE_QUESTIONS} questions, serial "
        f"{sv['serial_qps']:.1f}/s, coalesced {sv['coalesced_qps']:.1f}/s "
        f"({sv['coalesced_over_serial']:.2f}x; the reference's bar "
        f"{SERVE_TARGET:.0f}x), latency p50/p99 serial "
        f"{sv['serial_latency_p50_ms']:.2f}/"
        f"{sv['serial_latency_p99_ms']:.2f} ms, coalesced "
        f"{sv['coalesced_latency_p50_ms']:.2f}/"
        f"{sv['coalesced_latency_p99_ms']:.2f} ms, "
        f"{sv['k0_launches_per_window']:.1f} K0 launches a window, "
        f"card busy {sv['profile_window']['device_busy_share_traced']:.4f}"
        f" of a traced window")
    log("serving: " + json.dumps(sv))
    kernels[0]["serving_launches"] = sv["launches"].get("bank_score", 0)

    # the search phase runs after the kernels phase: it traces many
    # short loops, and a trace late in a long process can miss K4's one
    # 3 µs kernel, which the kernels phase's trace looks for
    t0 = time.perf_counter()
    report["search"] = phase_search(args.seed)
    report["search"]["phase_s"] = time.perf_counter() - t0
    sr = report["search"]
    log(f"search training: {sr['training_s']:.2f} s ({sr['measure_s']:.2f} "
        f"s measuring on the host, {sr['fit_s']:.2f} s fitting on the card)")
    for label in ("popsearch_hw3", "popsearch_trained"):
        ps = sr[label]
        log(f"search {label}: {ps['design']} {ps['cost_s']:.6e} s, "
            f"{ps['designs_costed']} designs in {ps['search_s']:.3f} s "
            f"({ps['designs_per_s']:.0f}/s), {ps['k0_launches']} K0 "
            f"launches; beam {ps['beam_cost_s']:.6e} s")
    log("search: " + json.dumps(sr))

    t0 = time.perf_counter()
    report["families"] = phase_families(args.seed)
    report["families_phase_s"] = time.perf_counter() - t0
    fam = report["families"]
    for name, res in fam.items():
        if name == "failures":
            continue
        log(f"families {name}: " + ", ".join(
            f"{k} {res[k]:.4f}" for k in ("prefill_s", "forward_s",
                                          "encode_s", "decode_tok_s",
                                          "peak_gb", "phase_s")
            if isinstance(res.get(k), float)))

    t0 = time.perf_counter()
    report["train"] = phase_train(args.seed)
    report["train_phase_s"] = time.perf_counter() - t0
    tr = report["train"]
    log(f"train: {tr['step_s_median']:.4f} s a step (median of steps 2-"
        f"{TRAIN_STEPS}), {tr['tokens_s']:.0f} tokens/s, "
        f"{tr['bf16_peak_share']:.4f} of the bf16 peak, device "
        f"{tr['device_ms_per_step']:.1f} ms a step in "
        f"{tr['profile_step']['launches_per_step']:.0f} launches (busy "
        f"{tr['device_busy_share']:.3f}), K5 {tr['k5_share_of_device']:.4f} "
        f"of it in {tr['k5_traced']:.0f} kernels (backward "
        f"{tr['k5_bwd_ms_per_step']:.2f} ms, "
        f"{tr['k5_bwd_share_of_device']:.4f}), peak "
        f"{tr['peak_gb']:.1f} GB, phase {report['train_phase_s']:.1f} s")

    t0 = time.perf_counter()
    report["distcalc"] = phase_distcalc(args.seed, report)
    report["distcalc_phase_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    report["dryrun"] = phase_dryrun(args.seed, report)
    report["dryrun_phase_s"] = time.perf_counter() - t0
    log(f"dryrun phase {report['dryrun_phase_s']:.1f} s")
    what_if = report["distcalc"].get("what_if", {})
    seamless = fam["seamless-m4t-large-v2"]
    kernels[5]["launches_by_path"] = {
        "lm qwen2-1.5b prefill": kernels[5]["launches"],
        "granite-moe prefill": fam["granite-moe-1b-a400m"]["k5_launches"],
        "zamba2 forward": fam["zamba2-1.2b"]["forward_k5_launches"],
        "seamless encode": seamless["encode_k5_launches"],
        "seamless forward": seamless["forward_k5_launches"],
        "seamless prefill_cross": seamless["prefill_cross_k5_launches"],
        "pixtral prefill": fam["pixtral-12b"]["k5_launches"],
        "qwen2-1.5b train step (forward and remat recompute)":
            tr["k5_counted"],
        f"qwen2-1.5b train, {TRAIN_STEPS} steps": tr["run_launches"],
        f"qwen2-1.5b train, resumed at step {TRAIN_CKPT_EVERY}":
            tr["resume_launches"],
        f"qwen2-1.5b remat-off what-if, {WHATIF_STEPS} steps":
            what_if.get("k5_launches"),
        "qwen2-1.5b train step counted by the dry run's counter":
            report["dryrun"]["real_step"]["k5_launches"]}
    kernels[5]["train_path"] = {
        "shape": f"[{TRAIN_BATCH},{12},{TRAIN_SEQ},128] kv_heads=2 bf16 "
                 f"causal (the lm row's shape)",
        "launches_per_step": tr["k5_counted"].get("flash_attention"),
        "traced_kernels_per_step": tr["k5_traced"],
        "traced_ms_mean": tr["k5_traced_ms_mean"],
        "ms_per_step": tr["k5_fwd_ms_per_step"],
        "forward_and_backward_ms_per_step": tr["k5_ms_per_step"],
        "share_of_step_device_time": tr["k5_share_of_device"]}
    # K5's backward: the main path is the train run, 28 launches a step
    kernels[6]["launches"] = tr["run_launches"].get("flash_attention_bwd", 0)
    kernels[6]["launches_by_path"] = {
        "qwen2-1.5b train step": tr["k5_counted"].get("flash_attention_bwd"),
        f"qwen2-1.5b train, {TRAIN_STEPS} steps":
            tr["run_launches"].get("flash_attention_bwd"),
        f"qwen2-1.5b train, resumed at step {TRAIN_CKPT_EVERY}":
            tr["resume_launches"].get("flash_attention_bwd"),
        f"qwen2-1.5b remat-off what-if, {WHATIF_STEPS} steps":
            (what_if.get("k5_launches") or {}).get("flash_attention_bwd"),
        "qwen2-1.5b train step counted by the dry run's counter":
            report["dryrun"]["real_step"]["k5_launches"].get(
                "flash_attention_bwd")}
    kernels[6]["train_path"] = {
        "launches_per_step": tr["k5_counted"].get("flash_attention_bwd"),
        "traced_kernels_per_step": tr["k5_traced_bwd"],
        "ms_per_step": tr["k5_bwd_ms_per_step"],
        "ms_per_step_by_kernel": tr["k5_bwd_ms_per_step_by_kernel"],
        "ms_each": tr["k5_bwd_ms_each"],
        "share_of_step_device_time": tr["k5_bwd_share_of_device"]}
    # the tf32x3 backward: the train phase's float32 first step, 28
    # launches (the float32-compute check's path)
    f32 = tr["first_step"]["float32_flash_launches"]
    kernels[7]["launches"] = f32.get("flash_attention_bwd_tf32x3", 0)
    kernels[7]["launches_by_path"] = {
        "qwen2-1.5b train, the float32 first step (flash)": f32}
    # the tf32x3 forward: every float32 flash run of the lm, families and
    # train phases
    by_path = {
        "lm qwen2-1.5b float32 prefill": lm["float32_flash_launches"],
        **{f"{name} float32 flash witness":
           fam[name]["vs_plain"]["float32_flash_k5_launches"]
           for name in ("granite-moe-1b-a400m", "zamba2-1.2b",
                        "seamless-m4t-large-v2", "pixtral-12b")},
        "seamless float32 prefill_cross":
            seamless["prefill_cross_float32_k5_launches"],
        "qwen2-1.5b train, the float32 first step (flash, remat)": f32}
    kernels[8]["launches"] = sum(c.get("flash_attention_tf32x3", 0)
                                 for c in by_path.values())
    kernels[8]["launches_by_path"] = by_path
    # the MoE combine: one launch a layer in the granite family's prefill
    # and in each of its decode steps (serve_batch)
    granite = fam["granite-moe-1b-a400m"]
    kernels[9]["launches"] = granite["moe_combine_launches"]
    kernels[9]["launches_by_path"] = {
        f"granite-moe serve_batch: prefill + {FAM_DECODE} decode steps":
            granite["moe_combine_launches"]}
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
