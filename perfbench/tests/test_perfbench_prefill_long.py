"""The ``prefill_long`` driver on a tiny Granite 4.0-H cell, on the CPU:
``correct`` true for the program as it is and false when every served
token is altered, with the real cell's limit; and the chunked scan's and
the hybrid prefill's work functions against hand counts.  The tiny cell
is added, as new files and entries, to ``tiny.make_root``'s copy of the
benchmark."""
from __future__ import annotations

import json
import math
import shutil
import time

import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench.yardstick import flops, hybrid

LONG = "granite-4.0-h-small.prefill-long32k"
TINY_LONG = "tiny-hybrid.prefill_long"

#: the tiny model: 3 Mamba2 layers and one attention layer, 8 experts
#: (top-3) and a shared expert
_MODEL = {"hidden_size": 64, "num_hidden_layers": 4,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "head_dim": 16, "intermediate_size": 32, "vocab_size": 256,
          "num_local_experts": 8, "num_experts_per_tok": 3,
          "shared_intermediate_size": 48, "mamba_n_heads": 8,
          "mamba_d_head": 16, "mamba_d_state": 16, "mamba_chunk_size": 8,
          "layer_types": ["mamba", "attention", "mamba", "mamba"]}
_PORT = {"d_model": 64, "n_layers": 4, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "vocab_size": 256, "d_ff": 32,
         "shared_expert_ff": 48, "ssm_state": 16, "ssm_head_dim": 16,
         "ssm_chunk": 8, "layer_types": _MODEL["layer_types"],
         "moe": {"n_experts": 8, "top_k": 3}}
#: the real cell's init rules at the tiny widths (1/sqrt of each
#: product's input width); the table's std keeps the real cell's logits'
#: spread (sqrt(d) x std / 16 = 0.02), the scale its limit is set in
_INIT = {"tok": {"std": 0.04}, "wo": {"std": 1 / 8},
         "out_proj": {"std": 1 / math.sqrt(128)},
         "w_down": {"std": 1 / math.sqrt(32)}}
_INIT.update({k: {"std": 1 / 8} for k in ("wq", "wk", "wv", "in_proj",
                                          "router", "w_gate", "w_up")})


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = tiny.make_root(tmp_path_factory.mktemp("cells"))
    pb = dest / "perfbench"
    bench = _load(dest / "BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    w = {c["name"]: c for c in bench["workloads"]}[LONG]
    cfg = _load(dest / configs[w["config"]]["file"])
    cfg["name"] = "tiny-hybrid"
    cfg["model"].update(_MODEL)
    cfg["port"]["overrides"].update(_PORT)
    cfg["init"].update(_INIT)
    _dump(cfg, pb / "configs" / "tiny-hybrid.json")
    mix = _load(pb / "traffic" / f"{w['traffic']}.json")
    mix.update(lengths=[16, 32, 64], per_block=[2, 1, 1])
    _dump(mix, pb / "traffic" / "tiny-prefill_long.json")
    shutil.copy(pb / "limits" / f"{LONG}.json",
                pb / "limits" / f"{TINY_LONG}.json")
    bench["configs"].append(dict(configs[w["config"]], name="tiny-hybrid",
                                 file="perfbench/configs/tiny-hybrid.json"))
    bench["workloads"].append(dict(w, name=TINY_LONG, config="tiny-hybrid",
                                   traffic="tiny-prefill_long"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LONG in m.get("workloads", ()):
            m["workloads"].append(TINY_LONG)
    _dump(bench, dest / "BENCHMARK.json")
    return dest


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # a test worker may hold the JAX package, loaded by other test files;
    # the guard against it is tested in a process of its own
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    import torch
    from repro_torch import runtime
    threads = torch.get_num_threads()       # a run sets its own
    yield
    torch.set_num_threads(threads)
    runtime.set_device(None)


def _run(root, seed, trace=0):
    """One run of the tiny cell in ``root`` (``harness.main``'s steps
    without its print; ``main`` takes the repository's root)."""
    return harness.run(["--workload", TINY_LONG, "--seed", str(seed),
                        "--seconds", "0.3", "--trace", str(trace)],
                       root, time.perf_counter(), device="cpu")


def test_the_program_as_it_is_is_correct(root):
    result = _run(root, 2 ** 31 + 13, trace=1)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 4 and result["failed"] == 0


def test_every_served_token_altered_is_caught(root, monkeypatch):
    from repro_torch.launch import serve

    def altered(logits):
        return ((logits.argmax(-1) + 1) % logits.shape[-1]).int()
    monkeypatch.setattr(serve, "greedy_sample", altered)
    result = _run(root, 29)
    assert result["correct"] is False, result["checks"]


def _readings(cell, dev, seed):
    from perfbench import calibrate
    from perfbench.drivers import prefill_long
    with prefill_long.this_reference():
        got = calibrate.prefill_readings(cell, dev, seed, {"control"})
    gap = "logit_gap_mean"
    return got["program"][gap], got["control"][gap], cell.limits[gap]


def test_the_calibration_reads_the_program_and_the_control(root):
    """``calibrate_long.py``'s readings: ``calibrate.py``'s prefill
    readings with this driver's reference.  At the tiny size the control's
    float8 products move no served token of three, so only the card test
    below holds it to the limit."""
    import torch
    from repro_torch import runtime
    runtime.set_device("cpu")
    program, control, limit = _readings(
        harness.Cell.load(root, TINY_LONG), torch.device("cpu"), 31)
    assert program <= limit and math.isfinite(control)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_control_fails_the_limit_at_the_cells_size(card):
    program, control, limit = _readings(harness.Cell.load(tiny.REPO, LONG),
                                        card, 2 ** 31 + 43)
    assert program <= limit < control


# ---- the work functions ----------------------------------------------------
def test_chunk_pairs_count_each_chunks_causal_pairs():
    assert hybrid.chunk_pairs(8, 8) == 36
    assert hybrid.chunk_pairs(20, 8) == 2 * 36 + 10
    assert hybrid.chunk_pairs(3, 8) == 6


def test_ssd_scan_by_hand():
    # 2 chunks of 4 (10 pairs each), 3 heads of 2, state 5, 1 group
    got = hybrid.ssd_scan(batch=2, seq=8, heads=3, head_dim=2, state=5,
                          groups=1, chunk=4, elem_bytes=2)
    pairs, hnp = 20, 3 * 5 * 2
    ops = 2 * pairs * (5 + 6) + 4 * 8 * hnp + 2 * 2 * hnp
    assert got["flops"] == 2 * ops
    assert got["bytes"] == 2 * (2 * 8 * (2 * 6 + 2 * 5) + 4 * 8 * 3)


def test_the_cells_scan_is_bound_by_its_bytes():
    """At the cell's 32,768 tokens the scan moves ~1.1 GB (x and y
    0.54 GB each) for ~0.2 TFLOP: bytes bound it on the H100."""
    model = _load(tiny.REPO / "perfbench" / "configs" /
                  "granite-4.0-h-small.json")["model"]
    work = hybrid.ssd_scan_of(model, 1, 32768, 2)
    assert work["bytes"] == 2 * 32768 * (2 * 8192 + 2 * 128) + \
        4 * 32768 * 128
    peaks = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    assert work["bytes"] / peaks["hbm_bytes_s"] > \
        work["flops"] / peaks["bf16_flops"]


def test_prefill_flops_sum_every_layers_products():
    model = dict(_MODEL, mamba_n_groups=1, mamba_expand=2,
                 tie_word_embeddings=True)
    d, t = 64, 2 * 16
    in_proj = d * (2 * 128 + 2 * 16 + 8)
    attn = d * 16 * (2 * 4 + 2 * 2)
    ffn = 3 * 3 * d * 32 + d * 8 + 3 * d * 48
    matrix = 3 * (in_proj + 128 * d) + attn + 4 * ffn
    want = (2 * matrix * t +
            3 * hybrid.ssd_scan(2, 16, 8, 16, 16, 1, 8, 2)["flops"] +
            4 * 2 * 4 * 16 * (16 * 17 // 2) + 2 * d * 256 * 2)
    assert hybrid.prefill_flops(model, 2, 16) == want
