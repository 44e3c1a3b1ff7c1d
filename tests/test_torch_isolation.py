"""The port stands alone: no module under src/repro_torch/ (nor
chip_smoke.py) imports JAX or the reference package, and without CUDA an
entry point that was not asked for the CPU raises instead of quietly
running on it."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = list(_port_modules())
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "leak = sorted(k for k in sys.modules\n"
            "              if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('LEAK', leak)\n"
            "assert not leak\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 20


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import runtime
    from repro_torch.core import elements, hardware, synthesis, whatif
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime.set_device(None)
    with pytest.raises(runtime.NoDeviceError):
        runtime.device()
    with pytest.raises(runtime.NoDeviceError):
        whatif.what_if_hardware(elements.spec_btree(),
                                synthesis.Workload(n_entries=10_000),
                                hardware.hw1(), hardware.hw2())
    with pytest.raises(runtime.NoDeviceError):
        hardware.hw1().model("quicksort").predict([10.0])
    # asked for the CPU explicitly, the same question runs
    assert runtime.device("cpu").type == "cpu"
    with runtime.use_device("cpu"):
        ans = whatif.what_if_hardware(elements.spec_btree(),
                                      synthesis.Workload(n_entries=10_000),
                                      hardware.hw1(), hardware.hw2())
        assert ans.baseline_seconds > 0
    with pytest.raises(runtime.NoDeviceError):
        runtime.device()


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """No GPU here: the script must exit non-zero and print no result —
    from the checkout, and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              cwd=script.parent, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
