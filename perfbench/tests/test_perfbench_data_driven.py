"""The harness is driven by data: a configuration, a traffic mix, limits
and a per-layer metric added as new files, and a cell added as an entry
of ``BENCHMARK.json``, are found and run by name, and no file that was
there is edited."""
from __future__ import annotations

import hashlib
import json

from perfbench.tests import tiny
from perfbench.tests.test_perfbench_guard import run_on_cpu

NEW_METRIC = "steps_traced.tiny"
READER = '''"""The traced steps' tokens (a count of the benchmark's own)."""


def read(r):
    return float(sum(s["tokens"] for s in r.steps))
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                    ).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_and_run_by_name(tmp_path):
    before = _digests(tiny.REPO)
    root = tiny.make_root(tmp_path)
    (root / "perfbench" / "metrics" / f"{NEW_METRIC}.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": NEW_METRIC, "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "train.loop",
        "moves": "train_tokens_per_s", "workloads": [tiny.TINY_TRAIN]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    copied = _digests(root)

    rc, out, err = run_on_cpu(root, ["--workload", tiny.TINY_TRAIN,
                                     "--seed", str(2 ** 31 + 3),
                                     "--seconds", "0.5", "--trace", "1"])
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True
    # the new metric is read; the device's are not measured on the CPU
    assert result["metrics"] == {NEW_METRIC: {"value": 2 * 2 * 64.0,
                                              "unit": "tokens"}}
    assert result["device"]["platform"] == "cpu"
    assert result["device"]["busy_s"] == "not measured"
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    # the numbers compared are the last lines of standard error
    assert err.strip().splitlines()[-1].startswith("check change_gap ")

    rc, out, err = run_on_cpu(root, ["--workload", tiny.TINY_PREFILL,
                                     "--seed", "9", "--seconds", "0.5",
                                     "--trace", "0"])
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"ttft_p95_ms", "setup_s"}
    assert all(m["value"] == "not measured"
               for m in result["metrics"].values())

    # every file that was there is as it was, in the copy and the repo
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in copied} == copied
    assert {k: v for k, v in before.items()} == {
        k: v for k, v in copied.items() if k in before}
