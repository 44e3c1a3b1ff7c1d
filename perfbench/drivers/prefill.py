"""Prefill serving: a closed loop of batches through the program's
``launch.serve.serve_batch``, one client issuing the next batch when the
last one's tokens are back on the host, so no request waits in a queue.

Each batch holds ``batch`` requests of one prompt length, and asks for
``new_tokens`` tokens (one: long-prompt scoring).  The lengths come in
blocks that hold each length ``per_block`` times in an order drawn from
the seed; the window runs whole blocks until ``--seconds`` have passed.
A request's time to first token runs from its batch's issue to its
batch's tokens on the host.  The driver gives the 95th percentile of it
over every request of the window, and the prompt tokens a second (all
those of the window's batches over its time); a cell reports those of
them that ``BENCHMARK.json`` lists for it.  Set-up draws the weights and serves one
batch of every length the mix sends.  With ``--trace 1`` the window runs
as without, and the next block follows it under the profiler, after one
batch that lets the profiler start.

What is compared: once the window has closed and the program's state is
freed, ``checked_batches`` of the batches it finished, drawn from the
seed with a longest one among them, are run through the float32
reference (each batch whole, since the experts' capacity is the
batch's); each served token's gap below the reference's best logit at
its position is summed up by ``compare.gap_stats``, and the limits file
names the statistics compared.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from perfbench.drivers import common
from perfbench.reference import decoder
from perfbench.yardstick import compare, traffic


def _quiet(*_args, **_kw) -> None:
    return None


def server(cell, cfg, params):
    """``serve(prompts) -> tokens [B, new_tokens]`` on the program."""
    from repro_torch.launch.serve import serve_batch
    new = int(cell.traffic["new_tokens"])

    def serve(prompts: np.ndarray) -> np.ndarray:
        return serve_batch(cfg, prompts, new, params=params,
                           log=_quiet)["tokens"]
    return serve


def prompts(cell, seed: int, j: int, length: int,
            stream: str = "prompts") -> np.ndarray:
    return traffic.prompts(seed, j, int(cell.traffic["batch"]), length,
                           int(cell.config["model"]["vocab_size"]), stream)


def warm_up(cell, seed: int, serve) -> None:
    """One batch of every length of the mix, longest first."""
    for j, length in enumerate(sorted(set(cell.traffic["lengths"]),
                                      reverse=True)):
        serve(prompts(cell, seed, j, length, "warm"))


def sample(cell, seed: int, served: Dict[int, Tuple[int, np.ndarray]]
           ) -> List[int]:
    """The batches to check: a longest one and others, drawn from the
    seed."""
    n = min(int(cell.traffic["checked_batches"]), len(served))
    r = traffic.rng(seed, "sample")
    longest = max(length for length, _ in served.values())
    first = [j for j, (length, _) in served.items() if length == longest]
    pick = [int(r.choice(first))]
    rest = [j for j in served if j != pick[0]]
    pick += [int(j) for j in r.choice(rest, size=n - 1, replace=False)]
    return sorted(pick)


def reference_gaps(cell, spec, seed: int, dev, served, picked,
                   precision: str = "float32") -> Dict[int, List[float]]:
    """Per checked batch, each request's gap under the float32 reference;
    with ``precision="fp8"`` the gaps of the tokens the fp8 reference
    puts first (the control)."""
    import torch
    W = common.reference_weights(cell, spec, seed, dev)
    dec = decoder.Decoder(cell.config["model"])
    low = decoder.Decoder(cell.config["model"], decoder.Matmul(precision))
    gaps = {}
    with decoder.exact_float32():
        for j in picked:
            length, tokens = served[j]
            p = torch.as_tensor(prompts(cell, seed, j, length), device=dev)
            ref = dec.last_logits(W, p)
            if precision != "float32":
                tokens = low.last_logits(W, p).argmax(-1)
            gaps[j] = compare.logit_gaps(ref, tokens)
            del ref
    del W
    common.free_device()
    return gaps


def run(cell, dev, seed: int, seconds: float, trace: bool, t0: float
        ) -> Dict:
    tr = cell.traffic
    rows = int(tr["batch"])
    vocab = int(cell.config["model"]["vocab_size"])
    cfg, _, spec, params = common.program(cell, seed, dev)
    serve = server(cell, cfg, params)
    warm_up(cell, seed, serve)
    common.reset_peak(dev)

    served: Dict[int, Tuple[int, np.ndarray]] = {}
    latencies: List[float] = []
    schedule = traffic.length_schedule(seed, tr["lengths"], tr["per_block"])
    out: Dict = {"failed": 0}
    j = 0

    def issue(length: int) -> None:
        nonlocal j
        p = prompts(cell, seed, j, length)
        t = time.perf_counter()
        tokens = serve(p)
        latencies.extend([time.perf_counter() - t] * rows)
        first = np.asarray(tokens)[:, 0]
        out["failed"] += int(((first < 0) | (first >= vocab)).sum())
        served[j] = (length, first)
        j += 1

    w0 = time.perf_counter()
    out["setup_s"] = w0 - t0
    for block in schedule:
        for length in block:
            issue(length)
        if time.perf_counter() - w0 >= seconds:
            break
    w1 = time.perf_counter()
    window = [{"batch": rows, "seq": length, "tokens": rows * length}
              for length, _ in served.values()]
    tokens = sum(s["tokens"] for s in window)
    ttft = traffic.nearest_rank(latencies, 0.95) * 1e3
    for n in sorted(set(tr["lengths"])):
        lat = [latencies[k * rows] for k, (length, _) in
               enumerate(served.values()) if length == n]
        print(f"perfbench: length {n}: {len(lat)} batches, seconds a "
              f"batch: least {min(lat):.4f}, median "
              f"{traffic.nearest_rank(lat, 0.5):.4f}, most "
              f"{max(lat):.4f}", file=sys.stderr)
    print(f"perfbench: {len(latencies)} requests in {len(served)} "
          f"batches; ttft p50 "
          f"{traffic.nearest_rank(latencies, 0.5) * 1e3:.3f} ms, p95 "
          f"{ttft:.3f} ms; {tokens / (w1 - w0):.1f} prompt tokens/s",
          file=sys.stderr)
    if not trace:
        out["end_to_end"] = {"prefill_tokens_per_s": tokens / (w1 - w0),
                             "ttft_p95_ms": ttft, "setup_s": out["setup_s"]}
    else:
        block = next(schedule)
        with common.profiler(dev) as prof:
            serve(prompts(cell, seed, 0, block[0], "warm"))
            for length in block:
                with common.step_span():
                    issue(length)
        steps = [{"batch": rows, "seq": length, "tokens": rows * length}
                 for length in block]
        reading, fields = common.traced(cell, dev, prof, steps)
        reading.window_steps, reading.window_s = window, w1 - w0
        out.update(fields, reading=reading, end_to_end={})
    out["attempted"] = len(latencies)
    out["memory_peak_bytes"] = common.memory_peak(dev)
    del serve, params
    common.free_device()

    picked = sample(cell, seed, served)
    t = time.perf_counter()
    gaps = reference_gaps(cell, spec, seed, dev, served, picked)
    print(f"perfbench: the reference took {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    stats = compare.gap_stats([g for j in picked for g in gaps[j]])
    print(f"perfbench: {sum(len(gaps[j]) for j in picked)} requests of "
          f"{len(picked)} batches checked (lengths "
          f"{sorted(served[j][0] for j in picked)}): {stats}",
          file=sys.stderr)
    out["checks"] = compare.checks(stats, cell.limits)
    out["correct"] = compare.held(out["checks"]) and out["failed"] == 0
    return out
