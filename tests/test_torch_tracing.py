"""The port's spans and tallies (``repro_torch/tracing.py``) on the CPU.

A span is a ``record_function`` range while a profiler records and costs
no profiler call otherwise; tallies count only while a profiler records,
and the kernels' launch counters (``repro_torch.kernels``) whether or not
one does.  A training step is five sibling phase spans, and each MoE
layer four sub-spans inside its ``moe_ffn``, then tallies whose
difference is :func:`repro_torch.models.moe.dropped`.
"""
import dataclasses

import pytest
import torch

from repro_torch import kernels, runtime, tracing
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import build
from repro_torch.models import moe
from repro_torch.train import loop

PHASES = ("train.forward", "train.loss", "train.backward", "train.clip",
          "train.adamw")
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def _cpu():
    tracing.reset_tallies()
    with runtime.use_device("cpu"):
        yield
    tracing.reset_tallies()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(prof, names):
    """(name, start, end) of the profiler's events called one of
    ``names``, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in names),
                  key=lambda s: s[1])


@pytest.fixture
def entries(monkeypatch):
    """The calls of the op a ``record_function`` enters."""
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*args):
        calls.append(args[0])
        return enter(*args)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    return calls


def test_span_enters_record_function_only_under_the_profiler(entries):
    with tracing.span("outside"):
        torch.ones(3).sum()
    assert entries == [] and not tracing.recording()
    # one shared no-op, whatever the name
    assert tracing.span("a") is tracing.span("b")
    # a bare record_function calls the profiler's op all the same
    with torch.profiler.record_function("bare"):
        pass
    assert entries == ["bare"]
    with _profiler() as prof:
        assert tracing.recording()
        with tracing.span("inside"):
            torch.ones(3).sum()
    assert entries == ["bare", "inside"] and not tracing.recording()
    assert [s[0] for s in _spans(prof, {"inside", "outside"})] == ["inside"]


def test_tallies_count_only_under_the_profiler():
    tracing.tally("t.host", 5)
    tracing.tally("t.dev", torch.tensor(2.0))
    assert tracing.tallies() == {}
    with _profiler():
        tracing.tally("t.host", 5)
        tracing.tally("t.host", 7)
        tracing.tally("t.dev", torch.tensor(2.0))
        with torch.inference_mode():
            tracing.tally("t.dev", torch.ones(4).sum())
        tracing.tally("t.dev", torch.tensor(3, dtype=torch.int64))
    tracing.tally("t.host", 100)
    assert tracing.tallies() == {"t.host": 12, "t.dev": 9}
    tracing.reset_tallies()
    assert tracing.tallies() == {}


def test_device_tallies_hold_sums_past_float32s_integers():
    big = 2 ** 24
    with _profiler():
        for _ in range(3):
            tracing.tally("t.big", torch.tensor(float(big)))
        tracing.tally("t.big", torch.tensor(1.0))
    assert tracing.tallies() == {"t.big": 3 * big + 1}


def test_launch_counters_count_with_or_without_the_profiler():
    kernels.reset_launch_counts()
    c = kernels.counter("tracing_test_kernel")
    assert c is kernels.counter("tracing_test_kernel")
    c.hit()
    with _profiler():
        c.hit()
    assert kernels.launch_counts()["tracing_test_kernel"] == 2
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["tracing_test_kernel"] == 0


def _train_run(**kw):
    return RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                     weight_decay=0.1, grad_clip=1.0, **kw)


def _dense(remat):
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              compute_dtype="float32", remat=remat)
    model = build(cfg)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    return model, {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


@pytest.mark.parametrize("remat", [False, True])
def test_a_train_step_is_five_sibling_phase_spans(remat):
    model, batch = _dense(remat)
    state = loop.init_state(model, 0, device="cpu")
    step = loop.make_train_step(model, _train_run())
    want, _ = step(state, batch)
    with _profiler() as prof:
        got, _ = step(state, batch)
    spans = _spans(prof, set(PHASES))
    assert [s[0] for s in spans] == list(PHASES)
    # siblings: each ends before the next starts
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    # the spans change nothing of the step
    for a, b in zip(loop.tree_leaves(want.params),
                    loop.tree_leaves(got.params)):
        assert torch.equal(a, b)


def test_microbatches_repeat_the_gradient_phases():
    model, batch = _dense(False)
    state = loop.init_state(model, 0, device="cpu")
    step = loop.make_train_step(model, _train_run(microbatch=1))
    with _profiler() as prof:
        step(state, batch)
    micro = ["train.forward", "train.loss", "train.backward",
             "train.backward"]
    assert [s[0] for s in _spans(prof, set(PHASES))] == \
        micro * 2 + ["train.clip", "train.adamw"]


def _moe_cfg(capacity_factor):
    cfg = get_smoke_config("granite-moe-1b-a400m")
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_ffn_tallies_its_drops(capacity_factor):
    cfg = _moe_cfg(capacity_factor)
    g = torch.Generator().manual_seed(3)
    params = moe.init_moe(g, cfg, device="cpu")
    x = torch.randn((2, 24, cfg.d_model), generator=g)
    want, _ = moe.moe_ffn(params, x, cfg)
    assert tracing.tallies() == {}
    with _profiler() as prof:
        got, _ = moe.moe_ffn(params, x, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    spans = _spans(prof, {"moe_ffn", *MOE_SPANS})
    assert [s[0] for s in spans] == ["moe_ffn", *MOE_SPANS]
    # the tally's one op lies after the layer's span, in none of its spans
    sums = _spans(prof, {"aten::sum"})
    assert [s for s in sums if s[1] >= spans[0][2]] == sums[-1:]
    r = moe.route(params, x.reshape(-1, cfg.d_model), cfg)
    t = tracing.tallies()
    assert t == {"moe.assigned": 48 * cfg.moe.top_k,
                 "moe.kept": t["moe.assigned"] - moe.dropped(r)}
    assert t["moe.kept"] <= moe.capacity(48, cfg) * cfg.moe.n_experts
    if capacity_factor < 1:
        assert moe.dropped(r) > 0


def test_every_moe_layer_of_a_forward_holds_the_four_spans():
    cfg = _moe_cfg(1.25)
    model = build(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), _profiler() as prof:
        model.forward(params, tokens)
    layers = _spans(prof, {"moe_ffn"})
    assert len(layers) == cfg.n_layers
    subs = _spans(prof, set(MOE_SPANS))
    for _, lo, hi in layers:
        inside = [s for s in subs if lo <= s[1] and s[2] <= hi]
        assert [s[0] for s in inside] == list(MOE_SPANS)
        assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))
    assert len(subs) == 4 * cfg.n_layers
    t = tracing.tallies()
    assert t["moe.assigned"] == cfg.n_layers * 32 * cfg.moe.top_k
    assert 0 <= t["moe.kept"] <= t["moe.assigned"]
