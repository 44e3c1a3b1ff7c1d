"""The program's phases and tallies as per-layer metrics
(``perfbench/yardstick/phases.py`` and the metric files that read it):
a kernel launched from another thread inside a phase span belongs to it,
the MoE tallies reach the prefill cell's line, and a CPU run of the
training cell leaves the device's phase metrics out."""
from __future__ import annotations

import json
import sys

import pytest

from perfbench.harness import Reading
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_guard import run_on_cpu
from perfbench.yardstick import phases
from perfbench.yardstick.trace import Trace

TRAIN_PHASES = ("fwd_ms.train", "loss_ms.train", "bwd_ms.train",
                "clip_ms.train", "adamw_ms.train",
                "optimizer_launches.train")
MOE_SPANS = ("moe_route_us_per_token.prefill",
             "moe_dispatch_us_per_token.prefill",
             "moe_experts_us_per_token.prefill",
             "moe_combine_us_per_token.prefill")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _synthetic():
    """One step (0-100 us) on thread 1: ``train.backward`` 10-40 us,
    ``train.adamw`` 50-90 us.  The autograd thread (2) launches a kernel
    at 12 us (it runs 15-20), a copy at 30 us (31-33) and a kernel at
    45 us, after the backward span (46-48); thread 1 launches two kernels
    inside ``train.adamw`` (55-60, 61-70)."""
    ev = [_x("user_annotation", "perfbench.step", 0, 100),
          _x("user_annotation", "train.backward", 10, 30),
          _x("user_annotation", "train.adamw", 50, 40)]
    for corr, (tid, launch, start, dur, cat) in enumerate(
            [(2, 12, 15, 5, "kernel"), (2, 30, 31, 2, "gpu_memcpy"),
             (2, 45, 46, 2, "kernel"), (1, 52, 55, 5, "kernel"),
             (1, 58, 61, 9, "kernel")]):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 1, tid=tid,
                     correlation=corr))
        ev.append(_x(cat, f"op{corr}", start, dur, tid=7, correlation=corr))
    return Trace(ev)


def _reading(trace):
    return Reading(model={}, steps=[{"batch": 1, "seq": 1, "tokens": 1}],
                   trace=trace, step_spans=trace.spans_named(
                       "perfbench.step"))


def test_a_kernel_launched_on_another_thread_inside_backward_is_backward():
    trace = _synthetic()
    r = _reading(trace)
    # the same-thread rule gives the backward span nothing
    assert trace.under("train.backward", 0.0, 1e-4)[1] == 0
    assert phases.phase_ms(r, "train.backward") == pytest.approx(7e-3)
    assert phases.phase_launches(r, ["train.backward"]) == 1
    assert phases.phase_ms(r, "train.adamw") == pytest.approx(14e-3)
    assert phases.phase_launches(r, ["train.backward", "train.adamw"]) == 3
    # the kernel launched after the span (45 us) counts for no phase
    assert phases.launched_under(trace, ["train.backward", "train.adamw"],
                                 0.0, 1e-4)[0] == pytest.approx(21e-6)


def test_a_phase_with_no_kernels_or_no_trace_reads_nothing():
    trace = _synthetic()
    assert phases.phase_ms(_reading(trace), "train.forward") is None
    assert phases.phase_launches(_reading(trace), ["train.loss"]) is None
    empty = Reading(model={}, steps=[{"batch": 1, "seq": 1, "tokens": 1}])
    assert phases.phase_ms(empty, "train.backward") is None


def test_span_union_merges_every_threads_spans():
    ev = [_x("user_annotation", "a", 0, 10, tid=1),
          _x("user_annotation", "a", 5, 10, tid=2),
          _x("user_annotation", "b", 12, 10, tid=1),
          _x("user_annotation", "a", 30, 1, tid=1)]

    def ends(names):
        return [x for iv in phases.span_union(Trace(ev), names) for x in iv]
    assert ends(["a"]) == pytest.approx([0.0, 15e-6, 30e-6, 31e-6])
    assert ends(["a", "b"]) == pytest.approx([0.0, 22e-6, 30e-6, 31e-6])


def test_a_program_without_tallies_reads_nothing(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert phases.program_tallies() is None
    assert phases.moe_counts() is None


def _run(root, cell, seed):
    rc, out, err = run_on_cpu(root, ["--workload", cell, "--seed",
                                     str(seed), "--seconds", "0.5",
                                     "--trace", "1"])
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    return result


def test_a_traced_moe_prefill_prints_its_drop_share(tmp_path):
    root = tiny.make_root(tmp_path)
    result = _run(root, tiny.TINY_PREFILL, 2 ** 31 + 11)
    m = result["metrics"]
    drop = m["moe_drop_share.prefill"]
    assert drop["unit"] == "%" and 0.0 <= drop["value"] <= 100.0
    # the device's numbers are not measured on the CPU
    for name in MOE_SPANS:
        assert name not in m


def test_a_traced_dense_train_run_leaves_the_phases_out_on_the_cpu(
        tmp_path):
    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]
              if tiny.TINY_TRAIN in m.get("workloads", ())}
    assert set(TRAIN_PHASES) <= listed
    result = _run(root, tiny.TINY_TRAIN, 2 ** 31 + 12)
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == "not measured"
