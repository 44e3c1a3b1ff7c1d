"""The frozen yardstick against hand values: traffic, FLOPs and bytes,
the trace reader and the comparison."""
from __future__ import annotations

import math

import numpy as np
import pytest

from perfbench.yardstick import compare, flops, readers, traffic
from perfbench.yardstick.trace import Trace

QWEN = {"hidden_size": 1536, "num_hidden_layers": 28,
        "num_attention_heads": 12, "num_key_value_heads": 2, "head_dim": 128,
        "intermediate_size": 8960, "vocab_size": 151936,
        "tie_word_embeddings": True, "qkv_bias": True}
GRANITE = {"hidden_size": 1024, "num_hidden_layers": 24,
           "num_attention_heads": 16, "num_key_value_heads": 8,
           "head_dim": 64, "intermediate_size": 512, "vocab_size": 49155,
           "num_local_experts": 32, "num_experts_per_tok": 8,
           "tie_word_embeddings": True}


# ---- traffic ----------------------------------------------------------------
def test_zipf_batch_is_a_function_of_seed_and_step():
    a = traffic.train_batch(3_000_000_001, 4, 2, 16, 50)
    b = traffic.train_batch(3_000_000_001, 4, 2, 16, 50)
    c = traffic.train_batch(3_000_000_001, 5, 2, 16, 50)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].dtype == np.int32 and a["tokens"].shape == (2, 16)
    # labels are the ids shifted by one
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_zipf_ids_are_clipped_to_the_vocabulary_and_heavy_headed():
    t = traffic.zipf_tokens(traffic.rng(7, "prompts"), 64, 512, 100)
    assert t.min() >= 1 and t.max() == 99
    # Zipf(1.3): P(1) = 1 / zeta(1.3) ~ 0.2546
    assert abs(np.mean(t == 1) - 0.2546) < 0.01


def test_seed_streams_differ_and_accept_large_seeds():
    big = 2 ** 31 + 12345
    assert traffic.derived_seed(big, "weights", 0) != \
        traffic.derived_seed(big, "weights", 1)
    assert 0 <= traffic.derived_seed(big, "weights", 0) < 2 ** 63
    p1 = traffic.prompts(big, 0, 2, 8, 1000)
    p2 = traffic.prompts(big, 0, 2, 8, 1000, stream="warm")
    assert not np.array_equal(p1, p2)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_a_length_block_holds_the_mix_whatever_the_seed(seed):
    blocks = [traffic.length_block(seed, b, [512, 1024, 2048, 4096],
                                   [4, 3, 2, 1]) for b in range(6)]
    for blk in blocks:
        assert sorted(blk) == [512] * 4 + [1024] * 3 + [2048] * 2 + [4096]
    assert len({tuple(b) for b in blocks}) > 1          # orders differ
    # the mean request of the mix: 13,312 / 10 tokens
    assert np.mean(blocks[0]) == pytest.approx(1331.2)


def test_nearest_rank():
    xs = list(range(1, 101))
    assert traffic.nearest_rank(xs, 0.95) == 95
    assert traffic.nearest_rank(xs, 0.5) == 50
    assert traffic.nearest_rank([3.0], 0.95) == 3.0


# ---- FLOPs and bytes --------------------------------------------------------
def test_causal_pairs_by_hand():
    assert flops.causal_pairs(1, 1) == 1
    assert flops.causal_pairs(4, 4) == 10
    assert flops.causal_pairs(2048, 2048) == 2048 * 2049 // 2
    assert flops.causal_pairs(6, 4) == 10 + 2 * 4


def test_qwen_parameter_count_and_step_flops():
    # 151,936 x 1,536 tied embedding + 28 layers + the final norm
    attn = 1536 * 128 * (2 * 12 + 2 * 2)
    bias = (12 + 4) * 128
    layer = attn + bias + 3 * 1536 * 8960 + 2 * 1536
    n = 28 * layer + 151936 * 1536 + 1536
    assert flops.n_params(QWEN) == n
    assert n == pytest.approx(1.5437e9, rel=1e-3)
    attn_fwd = 4 * 8 * 12 * 128 * (2048 * 2049 // 2) * 28
    assert flops.train_flops(QWEN, 8, 2048) == \
        pytest.approx(6 * n * 8 * 2048 + 3 * attn_fwd)
    assert flops.train_flops(QWEN, 8, 2048) == pytest.approx(1.60e14,
                                                             rel=0.01)


def test_granite_prefill_flops_count_the_active_experts():
    per_layer = 1024 * 64 * (2 * 16 + 2 * 8) + 8 * 3 * 1024 * 512 + \
        1024 * 32
    assert flops.active_matmul_params(GRANITE) == 24 * per_layer
    # ~0.76 GFLOP a token in the layers
    assert 2 * 24 * per_layer == pytest.approx(0.757e9, rel=0.01)
    got = flops.prefill_flops(GRANITE, 16, 4096)
    want = 2 * 24 * per_layer * 16 * 4096 + \
        4 * 16 * 16 * 64 * (4096 * 4097 // 2) * 24 + 2 * 1024 * 49155 * 16
    assert got == pytest.approx(want)


def test_granite_train_flops_count_the_active_experts():
    attn = 1024 * 64 * (2 * 16 + 2 * 8)
    rest = 2 * 1024 + 1024 * 32                   # norms and the router
    every = 24 * (attn + 32 * 3 * 1024 * 512 + rest) + 49155 * 1024 + 1024
    active = 24 * (attn + 8 * 3 * 1024 * 512 + rest) + 49155 * 1024 + 1024
    assert flops.n_params(GRANITE) == every
    assert flops.active_params(GRANITE) == active
    # a dense model meets every parameter
    assert flops.active_params(QWEN) == flops.n_params(QWEN)
    attn_fwd = 4 * 8 * 16 * 64 * (2048 * 2049 // 2) * 24
    assert flops.train_flops(GRANITE, 8, 2048) == \
        pytest.approx(6 * active * 8 * 2048 + 3 * attn_fwd)


def test_k5_work_by_hand():
    f = flops.k5_fwd(2, 4, 2, 8, 8, 16, 2)
    assert f["flops"] == 4 * 2 * 4 * 16 * 36
    # q and o (2 x 8 x 4 x 16 each), k and v (2 x 8 x 2 x 16), lse
    assert f["bytes"] == 2 * (2 * 1024 + 2 * 512) + 4 * 2 * 4 * 8
    b = flops.k5_bwd(2, 4, 2, 8, 8, 16, 2)
    assert b["flops"] == 10 * 2 * 4 * 16 * 36
    assert b["bytes"] == 2 * (4 * 1024 + 4 * 512) + 4 * 64
    peaks = flops.peak("NVIDIA H100 80GB HBM3")
    assert flops.least_seconds({"flops": 989e12, "bytes": 0.0}, peaks) == 1.0
    assert flops.least_seconds({"flops": 0.0, "bytes": 6.7e12}, peaks) == 2.0
    assert flops.peak("a card not in the table") is None


# ---- the trace reader -------------------------------------------------------
def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """Two steps (0-100 us, 100-200 us); K5's op launches kernel 1 in the
    first; a ``moe_ffn`` range launches kernels 2 and 3 (which overlap);
    kernel 4 comes from a plain op in the second step."""
    ev = [_x("user_annotation", "perfbench.step", 0, 100),
          _x("user_annotation", "perfbench.step", 100, 100),
          _x("cpu_op", "repro_torch::flash_attention_fwd", 5, 10),
          _x("cpu_op", "repro_torch::flash_attention_fwd", 6, 2),  # nested
          _x("cuda_runtime", "cudaLaunchKernel", 7, 1, corr=1),
          _x("kernel", "k5", 20, 30, tid=7, corr=1),
          _x("user_annotation", "moe_ffn", 110, 20),
          _x("cpu_op", "aten::bmm", 111, 5),
          _x("cuda_runtime", "cudaLaunchKernel", 112, 1, corr=2),
          _x("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=3),
          _x("kernel", "bmm", 120, 20, tid=7, corr=2),
          _x("kernel", "bmm", 130, 20, tid=7, corr=3),
          _x("cpu_op", "aten::add", 150, 10),
          _x("cuda_runtime", "cudaLaunchKernel", 151, 1, corr=4),
          _x("kernel", "add", 170, 10, tid=7, corr=4),
          _x("gpu_memset", "Memset (Device)", 185, 5, tid=7)]
    return Trace(ev)


def test_busy_time_is_the_union_of_device_intervals():
    t = synthetic_trace()
    lo, hi = 0.0, 200e-6
    # 20-50, 120-150 (two overlapping kernels), 170-180, 185-190
    assert t.busy_seconds(lo, hi) == pytest.approx(75e-6)
    assert t.kernel_count(lo, hi) == 4           # the memset is no kernel
    assert [round(s * 1e6, 6) for s in t.spans_named("perfbench.step")[1]
            ] == [100, 200]


def test_device_time_under_a_span_follows_the_launch():
    t = synthetic_trace()
    secs, count, unmatched = t.under("repro_torch::flash_attention_fwd",
                                     0.0, 200e-6)
    assert (round(secs * 1e6, 6), count) == (30, 1)
    assert unmatched == 1                         # the memset's
    secs, count, _ = t.under("moe_ffn", 0.0, 200e-6)
    assert (round(secs * 1e6, 6), count) == (40, 2)
    # a span nested in one of its own name counts once
    assert t.span_count("repro_torch::flash_attention_fwd", 0.0, 200e-6) == 1


def test_idle_gaps_are_put_to_the_launching_host_op():
    t = synthetic_trace()
    gaps = dict((n, round(s * 1e6, 6)) for n, s in t.idle_gaps(0.0, 200e-6))
    # 0-20 before K5's kernel, 50-120 before bmm, 150-170 before add,
    # 180-185 before the memset (no launch), 190-200 after the last
    assert gaps == {"repro_torch::flash_attention_fwd": 20, "aten::bmm": 70,
                    "aten::add": 20, "(no launch in the trace)": 5,
                    "(after the window's last device activity)": 10}
    top = t.top_device_ops(0.0, 200e-6)
    assert top[0][0] == "bmm" and top[0][1] == pytest.approx(40e-6)


class _Reading:
    def __init__(self, trace, steps, spans, model, window_steps=(),
                 window_s=None):
        self.trace, self.steps, self.step_spans = trace, steps, spans
        self.model, self.elem_bytes = model, 2
        self.peaks = flops.peak("NVIDIA H100 80GB HBM3")
        self.window_steps, self.window_s = list(window_steps), window_s

    @property
    def window(self):
        return self.step_spans[0][0], self.step_spans[-1][1]


def test_readers_on_the_synthetic_trace():
    t = synthetic_trace()
    model = {"hidden_size": 64, "num_hidden_layers": 1,
             "num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 16, "intermediate_size": 32, "vocab_size": 100,
             "tie_word_embeddings": True}
    steps = [{"batch": 2, "seq": 8, "tokens": 16}] * 2
    # an untraced window of 6 such steps in 500 us
    r = _Reading(t, steps, [(0.0, 100e-6), (100e-6, 200e-6)], model,
                 steps * 3, 500e-6)
    assert readers.launches_per_step(r) == 2.0
    # 75 us of device time for 32 traced tokens, 96 tokens in the window
    assert readers.idle_share(r) == pytest.approx(100 * (1 - 225 / 500))
    assert readers.span_us_per_token(r, "moe_ffn") == pytest.approx(40 / 32)
    least = flops.least_seconds(flops.k5_fwd(2, 4, 2, 8, 8, 16, 2),
                                r.peaks)
    assert readers.roofline(r, readers.K5_FWD_OP, flops.k5_fwd) == \
        pytest.approx(100 * least / 30e-6)
    assert readers.roofline(r, readers.K5_BWD_OP, flops.k5_bwd) is None
    assert readers.mfu(r, flops.train_flops) == pytest.approx(
        100 * 6 * flops.train_flops(model, 2, 8) / (500e-6 * 989e12))
    # no untraced window: no share of it
    r.window_steps, r.window_s = [], None
    assert readers.idle_share(r) is None
    assert readers.mfu(r, flops.train_flops) is None
    assert readers.launches_per_step(r) == 2.0


def test_readers_read_nothing_without_a_trace():
    class Empty:
        trace, window, steps, peaks = None, None, [], None
        window_steps, window_s = [], None
    for f in (readers.launches_per_step, readers.idle_share):
        assert f(Empty()) is None
    assert readers.mfu(Empty(), flops.train_flops) is None
    assert readers.span_us_per_token(Empty(), "moe_ffn") is None


# ---- the comparison ---------------------------------------------------------
def test_quiet_leaves_are_left_out_by_the_rule():
    ref = {"a": 1.0, "b": 2.0, "c": 3.0, "quiet": 1e-4}
    assert compare.counted_leaves(ref) == ["a", "b", "c"]


def test_leaf_gap_is_a_gap_of_norms_over_the_larger_base():
    ref = {"a": 1.0, "b": 2.0, "c": 0.001}
    prog = {"a": 1.005, "b": 2.0, "c": 0.011}
    gap, leaf = compare.leaf_gap(prog, ref, ["a", "b", "c"])
    # c: |0.011 - 0.001| / max(0.001, median 1.0) = 0.01
    assert leaf == "c" and gap == pytest.approx(0.01)
    # a leaf left unmoved reads 1
    gap, _ = compare.leaf_gap({"a": 0.0, "b": 2.0, "c": 0.001}, ref,
                              ["a", "b", "c"])
    assert gap == pytest.approx(1.0)


def test_loss_gap_and_limits():
    assert compare.loss_gap([10.0, 10.1], [10.0, 10.0]) == pytest.approx(0.01)
    assert compare.loss_gap([10.0], [10.0, 10.0]) == math.inf
    c = compare.checks({"x": 0.5, "y": float("nan")}, {"x": 1.0, "y": 1.0,
                                                       "z": 1.0})
    assert c["z"]["value"] == math.inf
    assert not compare.held(c)
    assert compare.held(compare.checks({"x": 0.5}, {"x": 1.0}))


def test_logit_gaps():
    import torch
    ref = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.0, -1.0]])
    assert compare.logit_gaps(ref, [1, 2]) == [0.0, 1.5]


def test_gap_stats_by_hand():
    got = compare.gap_stats([0.0] * 8 + [0.1, 0.5])
    assert got["logit_gap_mean"] == pytest.approx(0.06)
    assert got["logit_gap_p90"] == pytest.approx(0.1)
    assert got["logit_gap_max"] == pytest.approx(0.5)
    assert got["mismatch_share"] == pytest.approx(0.2)
