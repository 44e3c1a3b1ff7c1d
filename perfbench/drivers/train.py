"""A training job: the program's ``train.loop.make_train_step`` on one
state, batch after batch from the frozen Zipf generator.

Set-up draws the weights, builds the state with the program's AdamW
state, and takes the checked steps (``checked_steps`` of the traffic
file) through the window's own step call: they are the warm-up, and the
reference follows them once the window has closed; one more step
follows them in set-up.  The window steps on from the same state, each
step's loss read back to the host as a training loop does, until
``--seconds`` have passed; its rate is all the tokens of the steps it
completed over all its time.  No checkpoint is written.  With
``--trace 1`` the window runs as without, and ``trace_steps`` steps
follow it under the profiler, after one step that lets the profiler
start.

What is compared (see ``yardstick/compare.py``): each checked step's
loss; the first step's clipped gradient, leaf by leaf, as the program's
AdamW holds it after one step (its first moment over 1 - b1); and each
leaf's change over the checked steps.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

from perfbench.drivers import common
from perfbench.reference import decoder
from perfbench.yardstick import compare, traffic, weights


def _leaf_norms(tree) -> Dict[str, float]:
    import torch
    pairs = weights.leaf_paths(tree)
    norms = torch.stack([torch.linalg.vector_norm(t.float())
                         for _, t in pairs]).tolist()
    return {p: n for (p, _), n in zip(pairs, norms)}


def _change_norms(now: Dict, start: Dict) -> Dict[str, float]:
    import torch
    names = list(start)
    norms = torch.stack([torch.linalg.vector_norm(now[k].float() -
                                                  start[k].float())
                         for k in names]).tolist()
    return dict(zip(names, norms))


def optimizer(cell):
    from repro_torch.configs.base import RunConfig
    opt = cell.traffic["optimizer"]
    return RunConfig(**{k: opt[k] for k in (
        "learning_rate", "warmup_steps", "total_steps", "weight_decay",
        "grad_clip", "b1", "b2")})


def batches(cell, seed: int, dev):
    """``batch(i)``: step i's batch on the device."""
    import torch
    tr = cell.traffic
    rows, seq = int(tr["batch"]), int(tr["seq_len"])
    vocab = int(cell.config["model"]["vocab_size"])

    def batch(i: int) -> Dict[str, torch.Tensor]:
        b = traffic.train_batch(seed, i, rows, seq, vocab)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    return batch


def checked_steps(cell, dev, seed: int) -> Dict:
    """Set-up: the state, and the checked steps taken through the
    window's own step call.  Returns the state, the step, the batches,
    and the readings the reference is held to: ``losses``,
    ``first_grad`` and ``change`` (leaf by leaf)."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import TrainState, make_train_step
    b1 = cell.traffic["optimizer"]["b1"]
    batch = batches(cell, seed, dev)
    _, model, spec, params = common.program(cell, seed, dev)
    state = TrainState(params, adamw_init(params))
    del params
    step = make_train_step(model, optimizer(cell))
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for i in range(int(cell.traffic["checked_steps"])):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"].item()))
        if i == 0:
            first_grad = {k: v / (1.0 - b1)
                          for k, v in _leaf_norms(state.opt.mu).items()}
    start = weights.draw(spec, cell.config["init"], seed, dev)
    change = _change_norms(dict(weights.leaf_paths(state.params)), start)
    del start
    return {"spec": spec, "state": state, "step": step,
            "batch": batch, "losses": losses, "first_grad": first_grad,
            "change": change}


def judge(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: ``loss_gap``, ``grad_gap``, ``change_gap``."""
    kept = compare.counted_leaves(ref["first_grad"])
    grad_gap, grad_leaf = compare.leaf_gap(got["first_grad"],
                                           ref["first_grad"], kept)
    change_gap, change_leaf = compare.leaf_gap(got["change"], ref["change"],
                                               kept)
    print(f"perfbench: losses {got['losses']} reference {ref['losses']}; "
          f"{len(kept)} of {len(ref['first_grad'])} leaves counted; widest "
          f"gradient gap at {grad_leaf}, widest change gap at {change_leaf}",
          file=sys.stderr)
    return {"loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
            "grad_gap": grad_gap, "change_gap": change_gap}


def run(cell, dev, seed: int, seconds: float, trace: bool, t0: float
        ) -> Dict:
    tr = cell.traffic
    rows, seq = int(tr["batch"]), int(tr["seq_len"])
    got = checked_steps(cell, dev, seed)
    state, step, batch = got.pop("state"), got.pop("step"), got["batch"]
    i = int(tr["checked_steps"])
    # one more step, so that the window does not open on the first step
    # after the second weight draw
    state, m = step(state, batch(i))
    m["loss"].item()
    i += 1
    common.reset_peak(dev)

    out: Dict = {"failed": 0}
    w0 = time.perf_counter()
    out["setup_s"] = w0 - t0
    ends = [w0]
    while True:
        state, m = step(state, batch(i))
        if not math.isfinite(float(m["loss"].item())):
            out["failed"] += 1
        i += 1
        ends.append(time.perf_counter())
        if ends[-1] - w0 >= seconds:
            break
    w1, n = ends[-1], len(ends) - 1
    times = [b - a for a, b in zip(ends, ends[1:])]
    slowest = max(range(n), key=times.__getitem__)
    print(f"perfbench: {n} steps, seconds a step: least {min(times):.4f}"
          f", median {sorted(times)[n // 2]:.4f}, most "
          f"{times[slowest]:.4f} (step {slowest + 1} of the window)",
          file=sys.stderr)
    out["attempted"] = n
    shape = {"batch": rows, "seq": seq, "tokens": rows * seq}
    if not trace:
        out["end_to_end"] = {"train_tokens_per_s": n * rows * seq / (w1 - w0),
                             "setup_s": out["setup_s"]}
    else:
        k = int(tr["trace_steps"])
        with common.profiler(dev) as prof:
            state, m = step(state, batch(i))     # the profiler's first step
            m["loss"].item()
            i += 1
            for _ in range(k):
                with common.step_span():
                    state, m = step(state, batch(i))
                    if not math.isfinite(float(m["loss"].item())):
                        out["failed"] += 1
                i += 1
        out["attempted"] += k + 1
        reading, fields = common.traced(cell, dev, prof, [shape] * k)
        reading.window_steps, reading.window_s = [shape] * n, w1 - w0
        out.update(fields, reading=reading, end_to_end={})
    out["memory_peak_bytes"] = common.memory_peak(dev)
    del state, m, step
    common.free_device()

    # the reference, once the program's state is freed
    t = time.perf_counter()
    ref = reference(cell, got["spec"], seed, dev,
                    [batch(j) for j in range(int(tr["checked_steps"]))])
    print(f"perfbench: the reference took {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    out["checks"] = compare.checks(judge(got, ref), cell.limits)
    out["correct"] = compare.held(out["checks"]) and out["failed"] == 0
    return out


def reference(cell, spec, seed: int, dev, data, precision="float32"
              ) -> Dict:
    """The reference's checked steps from the same weights and batches:
    its losses, each leaf's first clipped gradient norm and each leaf's
    change."""
    W = common.reference_weights(cell, spec, seed, dev)
    dec = decoder.Decoder(cell.config["model"], decoder.Matmul(precision))
    with decoder.exact_float32():
        got = decoder.train(dec, W, data, cell.traffic["optimizer"])
    start = common.reference_weights(cell, spec, seed, dev)
    got["change"] = _change_norms(W, start)
    del W, start
    common.free_device()
    return got
