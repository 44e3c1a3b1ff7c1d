"""``correct`` comes out false when the timed path is broken underneath,
once for each fault the cells can have, and when the control (the
reference in float8) is put in the program's place; and true for the
program as it is.  Tiny cells on the CPU, with the real cells' limits."""
from __future__ import annotations

import time

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # a test worker may hold the JAX package, loaded by other test files;
    # the guard against it is tested in a process of its own
    # (test_perfbench_guard.py)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    import torch
    from repro_torch import runtime
    threads = torch.get_num_threads()       # a run sets its own
    yield
    torch.set_num_threads(threads)
    runtime.set_device(None)


def _run(root, cell, seed, trace=0):
    return harness.run(["--workload", cell, "--seed", str(seed),
                        "--seconds", "0.3", "--trace", str(trace)],
                       root, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", [tiny.TINY_TRAIN, tiny.TINY_PREFILL])
def test_the_program_as_it_is_is_correct(root, cell):
    result = _run(root, cell, 2 ** 31 + 11)
    assert result["correct"] is True, result["checks"]


def test_a_step_that_returns_its_state_unchanged_is_caught(root,
                                                           monkeypatch):
    from repro_torch.train import loop

    def unchanged(state, batch, model, run):
        _, metrics = STEP(state, batch, model, run)
        return state, metrics
    STEP = loop.train_step
    monkeypatch.setattr(loop, "train_step", unchanged)
    result = _run(root, tiny.TINY_TRAIN, 21)
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(root, monkeypatch):
    from repro_torch.train import loop
    STEP = loop.train_step

    def half(state, batch, model, run):
        return STEP(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()},
                    model, run)
    monkeypatch.setattr(loop, "train_step", half)
    result = _run(root, tiny.TINY_TRAIN, 22)
    assert result["correct"] is False


def test_an_altered_token_is_caught(root, monkeypatch):
    from repro_torch.launch import serve

    def altered(logits):
        return ((logits.argmax(-1) + 1) % logits.shape[-1]).int()
    monkeypatch.setattr(serve, "greedy_sample", altered)
    result = _run(root, tiny.TINY_PREFILL, 23, trace=1)
    assert result["correct"] is False


def _control(cell, root, dev, seed):
    from perfbench import calibrate
    c = harness.Cell.load(root, cell)
    readings = {"train": calibrate.train_readings,
                "prefill": calibrate.prefill_readings}[c.traffic["kind"]]
    got = readings(c, dev, seed, {"control"})
    assert np.isfinite(list(got["control"].values())).all()
    return got, c.limits


def test_the_control_reads_far_above_the_program_at_a_tiny_size(root):
    """The training control on the CPU reads at least three times the
    program on one of its numbers.  At two layers the control's error
    stays under the limits set at the cell's 28 (the readings of
    ``PERF.md``), so the limits themselves are held by the card test
    below, at the cells' own size."""
    import torch
    from repro_torch import runtime
    runtime.set_device("cpu")
    got, limits = _control(tiny.TINY_TRAIN, root, torch.device("cpu"), 31)
    assert all(got["program"][k] <= limits[k] for k in limits), got
    assert any(got["control"][k] >= 3 * got["program"][k] for k in limits)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cells' own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.PREFILL])
def test_the_control_fails_a_number_at_the_cells_size(card, cell):
    got, limits = _control(cell, tiny.REPO, card, 2 ** 31 + 41)
    assert all(got["program"][k] <= limits[k] for k in limits), got
    assert any(got["control"][k] > limits[k] for k in limits), got


def test_a_number_that_is_not_finite_keeps_the_line_json(root, monkeypatch,
                                                         capsys):
    import json
    from perfbench.yardstick import compare
    monkeypatch.setattr(compare, "gap_stats",
                        lambda gaps: {"logit_gap_mean": float("nan")})
    result = _run(root, tiny.TINY_PREFILL, 5)
    assert result["correct"] is False
    line = json.dumps(result, allow_nan=False)
    assert json.loads(line)["checks"]["logit_gap_mean"]["value"] == "nan"
    harness.report_checks(result["checks"])
    assert capsys.readouterr().err.strip().endswith("FAILED")
