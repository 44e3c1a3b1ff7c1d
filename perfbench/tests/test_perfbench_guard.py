"""Nothing the benchmark runs imports JAX or the JAX package; the reference
imports nothing of the program; a run without a card, or without the
program beside it, gives no result."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests import tiny

PERFBENCH = tiny.REPO / "perfbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return sorted(p for p in PERFBENCH.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(tiny.REPO)): name
             for p in _sources() for name in _imports(p)
             if name.split(".")[0] in harness.FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    for p in (PERFBENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(p)}
        assert not tops & {"repro_torch", "repro"}, p
        assert not any(n.startswith("perfbench") for n in _imports(p)), p


def test_top_level_names_are_compared_whole(monkeypatch):
    import types
    for name in [m for m in list(sys.modules)
                 if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tiny.REPO / "src")
    return env


RUN_ON_CPU = ("import sys, time; t0 = time.perf_counter(); {pre}"
              "sys.path[:0] = [{root!r}]; from perfbench import harness; "
              "sys.exit(harness.main(sys.argv[1:], t0, device='cpu'))")


def run_on_cpu(root: Path, argv, pre: str = ""):
    """A run of the benchmark in ``root`` on the CPU, in a process of its
    own: (exit code, stdout, stderr)."""
    code = RUN_ON_CPU.format(pre=pre, root=str(root))
    p = subprocess.run([sys.executable, "-c", code, *argv], cwd=root,
                       env=_env(), capture_output=True, text=True,
                       timeout=240)
    return p.returncode, p.stdout, p.stderr


def test_a_run_that_loads_the_jax_package_prints_no_result(tmp_path):
    root = tiny.make_root(tmp_path)
    argv = ["--workload", tiny.TINY_PREFILL, "--seed", "4",
            "--seconds", "0.2", "--trace", "0"]
    rc, out, err = run_on_cpu(root, argv)
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True
    rc, out, err = run_on_cpu(root, argv, pre="import repro.configs; ")
    assert rc == 3 and out == ""
    assert "repro" in err.splitlines()[-1]


def test_a_metric_reader_that_loads_the_jax_package_prints_no_result(
        tmp_path):
    """The look at ``sys.modules`` comes after the per-layer readers have
    been loaded and run: a reader (or anything it imports) that loads the
    JAX package leaves the run without a result."""
    root = tiny.make_root(tmp_path)
    name = "loads_repro.tiny"
    (root / "perfbench" / "metrics" / f"{name}.py").write_text(
        "import repro.configs  # noqa: F401\n\n\ndef read(r):\n"
        "    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": name, "unit": "launches", "better": "lower",
        "source": "program_counter", "layer": "launch.serve",
        "moves": "ttft_p95_ms", "workloads": [tiny.TINY_PREFILL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    rc, out, err = run_on_cpu(root, ["--workload", tiny.TINY_PREFILL,
                                     "--seed", "5", "--seconds", "0.2",
                                     "--trace", "1"])
    assert rc == 3 and out == "", err
    assert "repro" in err.splitlines()[-1]


def test_without_a_card_the_benchmark_prints_no_result(tmp_path):
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root = tiny.make_root(tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        tiny.TINY_TRAIN, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_without_the_program_beside_it_the_benchmark_prints_no_result(
        tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cell = json.loads((tmp_path / "BENCHMARK.json").read_text()
                      )["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
