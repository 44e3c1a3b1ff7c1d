"""Tiny cells for the CPU tests: a copy of ``BENCHMARK.json`` and the
benchmark's files in a temporary root, with a two-layer dense training
cell and a two-layer MoE prefill cell added as new files and entries.

The tiny cells keep the real cells' dtypes, steps, length blocks and
limits; only the widths, depth, vocabulary, batch and lengths are cut to
what a test run holds.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TRAIN = "qwen2-1.5b.train-8x2048"
PREFILL = "granite-moe-1b-a400m.prefill-mix16"
TINY_TRAIN = "tiny-dense.train"
TINY_PREFILL = "tiny-moe.prefill"

_SIZES = {"hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "head_dim": 16, "vocab_size": 256}
_PORT = {"d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "vocab_size": 256}


def _load(path: Path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def _tiny_config(src: dict, name: str, ff: int, experts=None) -> dict:
    c = json.loads(json.dumps(src))
    c["name"] = name
    c["model"].update(_SIZES, intermediate_size=ff)
    over = c["port"]["overrides"]
    over.update(_PORT, d_ff=ff)
    if experts:
        c["model"].update(num_local_experts=experts[0],
                          num_experts_per_tok=experts[1])
        over["moe"] = {"n_experts": experts[0], "top_k": experts[1]}
    return c


def make_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``perfbench/`` as in the
    repository, plus the two tiny cells.  Returns ``dest``."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = dest / "perfbench"
    bench = _load(dest / "BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    added = []
    for real, tiny, ff, experts, traffic in (
            (TRAIN, TINY_TRAIN, 128, None,
             {"batch": 2, "seq_len": 64, "trace_steps": 2}),
            (PREFILL, TINY_PREFILL, 32, (8, 2),
             {"batch": 4, "lengths": [16, 32], "per_block": [2, 1],
              "checked_batches": 3})):
        w = cells[real]
        name = tiny.split(".")[0]
        cfg = _tiny_config(_load(dest / configs[w["config"]]["file"]), name,
                           ff, experts)
        _dump(cfg, pb / "configs" / f"{name}.json")
        mix = _load(pb / "traffic" / f"{w['traffic']}.json")
        mix.update(traffic)
        _dump(mix, pb / "traffic" / f"tiny-{mix['kind']}.json")
        shutil.copy(pb / "limits" / f"{real}.json",
                    pb / "limits" / f"{tiny}.json")
        bench["configs"].append(dict(configs[w["config"]], name=name,
                                     file=f"perfbench/configs/{name}.json"))
        bench["workloads"].append(dict(w, name=tiny, config=name,
                                       traffic=f"tiny-{mix['kind']}"))
        added.append((real, tiny))
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in added:
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    _dump(bench, dest / "BENCHMARK.json")
    return dest
