"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` compiles, at first use, into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout (a
directory ``.gitignore`` lists); the digest covers the source and the
compiler flags, so an edited source rebuilds and a stale library is never
loaded.  Sources expose a plain C interface, so the build needs no
PyTorch headers and takes seconds.  :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parents[1] / "build" / "kernels"

#: library name -> its source under csrc/
SOURCES = {"sorted_search": "sorted_search.cu",
           "hash_probe": "hash_probe.cu",
           "scan_filter": "scan_filter.cu",
           "bloom_probe": "bloom_probe.cu",
           "flash_attention": "flash_attention.cu",
           "moe_combine": "moe_combine.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: where Triton keeps the kernels it compiles: beside the nvcc libraries,
#: so that a checkout's later processes find them compiled
TRITON_CACHE = BUILD_DIR.parent / "triton"

_BUILD_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """Where library ``name`` of the current source lives once built."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of library ``name``."""
    return BUILD_DIR / f"{name}.log"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every missing library of ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns name -> path."""
    names = list(SOURCES if names is None else names)
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {n: library_path(n) for n in names}
        jobs = {}
        for n, out in paths.items():
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[n])]
            jobs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        failed = []
        for n, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            build_log(n).write_text(log)
            if proc.returncode != 0:
                failed.append(f"{n} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
        if failed:
            raise KernelBuildError("nvcc failed for " + "\n".join(failed))
        return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Library ``name``, built first if needed, loaded once per process."""
    return ctypes.CDLL(str(build([name])[name]))


def use_triton_cache() -> None:
    """Point Triton's cache at :data:`TRITON_CACHE`, unless the
    environment names one.  Call before Triton compiles."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE))


def triton_libdevice():
    """Triton's handle on CUDA's libdevice (precise ``expf``, ``logf``);
    its import path moved between Triton releases."""
    try:
        from triton.language.extra import libdevice
        return libdevice
    except ImportError:
        pass
    try:
        from triton.language.extra.cuda import libdevice
        return libdevice
    except ImportError:
        import triton.language as tl
        return tl.math


def check(status: int, kernel: str) -> None:
    """Raise when a launcher reports a CUDA error (a refused launch never
    runs, and no later synchronise would report it)."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error "
                           f"{status}")
