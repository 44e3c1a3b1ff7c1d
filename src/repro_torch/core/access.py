"""Data access primitives (paper §3 + Appendix D, Table 1).

Level-1 primitives are conceptual access patterns used by the cost
synthesizer; each resolves to one Level-2 primitive — a concrete minimal
implementation with a micro-benchmark and a learned cost model.

The benchmark implementations below follow Appendix D's pseudocode
(scalar scans, binary/interpolation search, hash and bloom probes,
quicksort, (batched) random memory access, writes).  They run live on this
container to produce the CPU hardware profile; the fitted models are then
the only thing the synthesizer touches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Level-1 primitive names (Table 1 left column)
# ---------------------------------------------------------------------------
SCAN = "scan"
SORTED_SEARCH = "sorted_search"
HASH_PROBE = "hash_probe"
BLOOM_PROBE = "bloom_probe"
SORT = "sort"
RANDOM_ACCESS = "random_access"
BATCHED_RANDOM_ACCESS = "batched_random_access"
SERIAL_WRITE = "serial_write"
ORDERED_BATCH_WRITE = "ordered_batch_write"
SCATTERED_BATCH_WRITE = "scattered_batch_write"

LEVEL1 = (SCAN, SORTED_SEARCH, HASH_PROBE, BLOOM_PROBE, SORT, RANDOM_ACCESS,
          BATCHED_RANDOM_ACCESS, SERIAL_WRITE, ORDERED_BATCH_WRITE,
          SCATTERED_BATCH_WRITE)


@dataclasses.dataclass(frozen=True)
class Level2Primitive:
    """A concrete implementation of a Level-1 access pattern."""

    name: str              # e.g. "binary_search_columnstore"
    level1: str            # parent Level-1 primitive
    model_kind: str        # which cost model family fits it (Table 1 right)
    benchmark: Callable[[int, int], float]  # (size, reps) -> sec/op
    sizes: Tuple[int, ...] = (1 << 7, 1 << 9, 1 << 11, 1 << 13, 1 << 15,
                              1 << 17, 1 << 19, 1 << 21)
    doc: str = ""


def _time_op(fn: Callable[[], None], reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# Benchmark implementations (Appendix D pseudocode, vectorized where the
# C++ original is a tight loop — numpy IS this container's tight loop).
# ---------------------------------------------------------------------------
_rng = np.random.default_rng(1234)


def _bench_scan_row_equal(n: int, reps: int) -> float:
    arr = _rng.integers(0, n * 4, size=(n, 2)).astype(np.int64)  # kv pairs
    probes = _rng.integers(0, n * 4, size=reps).astype(np.int64)

    def op(i=[0]):
        x = probes[i[0] % reps]; i[0] += 1
        np.flatnonzero(arr[:, 0] == x)

    return _time_op(op, reps)


def _bench_scan_col_equal(n: int, reps: int) -> float:
    keys = _rng.integers(0, n * 4, size=n).astype(np.int64)
    probes = _rng.integers(0, n * 4, size=reps).astype(np.int64)

    def op(i=[0]):
        x = probes[i[0] % reps]; i[0] += 1
        np.flatnonzero(keys == x)

    return _time_op(op, reps)


def _bench_scan_col_range(n: int, reps: int) -> float:
    keys = _rng.integers(0, n * 4, size=n).astype(np.int64)
    values = _rng.integers(0, n * 4, size=n).astype(np.int64)
    probes = _rng.integers(0, n * 4, size=reps).astype(np.int64)

    def op(i=[0]):
        x = probes[i[0] % reps]; i[0] += 1
        values[keys < x]

    return _time_op(op, reps)


def _sorted_keys(n: int) -> np.ndarray:
    return np.sort(_rng.integers(0, n * 4, size=n).astype(np.int64))


def _bench_binary_search_col(n: int, reps: int) -> float:
    keys = _sorted_keys(n)
    probes = _rng.integers(0, n * 4, size=reps).astype(np.int64)

    def op(i=[0]):
        x = probes[i[0] % reps]; i[0] += 1
        lo, hi = 0, n - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if keys[mid] < x:
                lo = mid + 1
            else:
                hi = mid

    return _time_op(op, reps)


def _bench_binary_search_row(n: int, reps: int) -> float:
    arr = np.empty((n, 2), dtype=np.int64)
    arr[:, 0] = _sorted_keys(n)
    arr[:, 1] = np.arange(n)
    probes = _rng.integers(0, n * 4, size=reps).astype(np.int64)

    def op(i=[0]):
        x = probes[i[0] % reps]; i[0] += 1
        lo, hi = 0, n - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if arr[mid, 0] < x:
                lo = mid + 1
            else:
                hi = mid

    return _time_op(op, reps)


def _bench_interpolation_search(n: int, reps: int) -> float:
    keys = np.sort(_rng.integers(0, n * 8, size=n).astype(np.int64))
    probes = keys[_rng.integers(0, n, size=reps)]

    def op(i=[0]):
        x = probes[i[0] % reps]; i[0] += 1
        lo, hi = 0, n - 1
        klo, khi = int(keys[lo]), int(keys[hi])
        it = 0
        while lo < hi and klo <= x <= khi and it < 64:
            it += 1
            denom = max(khi - klo, 1)
            si = lo + int((hi - lo) * (x - klo) / denom)
            si = min(max(si, lo), hi)
            k = int(keys[si])
            if k < x:
                lo = si + 1
                klo = int(keys[lo]) if lo < n else k
            elif k == x:
                break
            else:
                hi = si
                khi = int(keys[hi])

    return _time_op(op, reps)


def _bench_hash_probe(n: int, reps: int) -> float:
    """Multiply-shift probe with serialized dependent accesses (Appendix D)."""
    k = max(n, 32)
    pa = _rng.integers(0, max(k - 20, 1), size=k).astype(np.int64)
    sa = _rng.integers(0, 20, size=reps).astype(np.int64)
    a = int(_rng.integers(1, 1 << 62)) | 1
    s = max(int(np.log2(k)), 1)

    def run():
        x = 0
        for i in range(reps):
            x = (a * (int(pa[x]) + int(sa[i]))) % (1 << 64) >> (64 - s)
            x = min(x, k - 1)
        return x

    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) / reps


def _bench_bloom_probe(n: int, reps: int, num_hashes: int = 2) -> float:
    bits = max(n, 64)
    s = max(int(np.log2(bits)), 3)
    bf = np.zeros(bits // 8 + 1, dtype=np.uint8)
    hashes = [(int(_rng.integers(1, 1 << 62)) | 1) for _ in range(num_hashes)]
    keys = _rng.integers(0, 1 << 40, size=reps).astype(np.int64)
    for x in keys[: reps // 2].tolist():  # half the probes hit
        for a in hashes:
            hb = (a * x) % (1 << 64) >> (64 - s)
            bf[hb >> 3] |= 1 << (hb & 7)

    def op(i=[0]):
        x = int(keys[i[0] % reps]); i[0] += 1
        for a in hashes:
            hb = (a * x) % (1 << 64) >> (64 - s)
            if not (bf[hb >> 3] >> (hb & 7)) & 1:
                return False
        return True

    return _time_op(op, reps)


def _bench_quicksort(n: int, reps: int) -> float:
    def op():
        data = _rng.integers(0, n * 4, size=n).astype(np.int64)
        np.sort(data, kind="quicksort")

    return _time_op(op, max(reps // 4, 1))


def _bench_random_access(n: int, reps: int) -> float:
    """Dependent pointer chase over a region of n int64 slots (Appendix D)."""
    k = max(n, 32)
    pa = _rng.integers(0, max(k - 20, 1), size=k).astype(np.int64)
    sa = _rng.integers(0, 20, size=reps).astype(np.int64)

    def run():
        p = 0
        for i in range(reps):
            p = int(pa[p]) + int(sa[i])
        return p

    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) / reps


def _bench_batched_random_access(n: int, reps: int) -> float:
    """Independent gathers — the CPU may overlap the memory requests."""
    k = max(n, 32)
    pa = _rng.integers(0, k, size=k).astype(np.int64)
    sa = _rng.integers(0, k, size=reps).astype(np.int64)

    def op():
        pa[sa].sum()

    t = _time_op(op, max(reps // 64, 1))
    return t / reps  # per access


def _bench_serial_write(n: int, reps: int) -> float:
    src = _rng.integers(0, n * 4, size=n).astype(np.int64)
    dst = np.empty_like(src)

    def op():
        np.copyto(dst, src)

    return _time_op(op, max(reps // 8, 1))


def _bench_ordered_batch_write(n: int, reps: int) -> float:
    src = np.sort(_rng.integers(0, n * 4, size=n).astype(np.int64))
    dst = np.empty_like(src)

    def op():
        np.copyto(dst, src)

    return _time_op(op, max(reps // 8, 1))


def _bench_scattered_batch_write(n: int, reps: int) -> float:
    k = max(n, 32)
    idx = _rng.permutation(k)
    src = _rng.integers(0, k, size=k).astype(np.int64)
    dst = np.empty_like(src)

    def op():
        dst[idx] = src

    return _time_op(op, max(reps // 8, 1))


# ---------------------------------------------------------------------------
# Registry (Table 1): Level-2 primitive -> (Level-1 parent, model family)
# ---------------------------------------------------------------------------
LEVEL2: Dict[str, Level2Primitive] = {p.name: p for p in [
    Level2Primitive("scalar_scan_rowstore_equal", SCAN, "linear",
                    _bench_scan_row_equal),
    Level2Primitive("scalar_scan_columnstore_equal", SCAN, "linear",
                    _bench_scan_col_equal),
    Level2Primitive("scalar_scan_columnstore_range", SCAN, "linear",
                    _bench_scan_col_range),
    Level2Primitive("binary_search_rowstore", SORTED_SEARCH, "log_linear",
                    _bench_binary_search_row),
    Level2Primitive("binary_search_columnstore", SORTED_SEARCH, "log_linear",
                    _bench_binary_search_col),
    Level2Primitive("interpolation_search_columnstore", SORTED_SEARCH,
                    "log_loglog", _bench_interpolation_search),
    Level2Primitive("hash_probe_multiply_shift", HASH_PROBE, "sigmoids",
                    _bench_hash_probe),
    Level2Primitive("bloom_probe_multiply_shift", BLOOM_PROBE, "sigmoids",
                    _bench_bloom_probe),
    Level2Primitive("quicksort", SORT, "nlogn", _bench_quicksort),
    Level2Primitive("random_memory_access", RANDOM_ACCESS, "sigmoids",
                    _bench_random_access,
                    sizes=(1 << 8, 1 << 10, 1 << 12, 1 << 14, 1 << 16,
                           1 << 18, 1 << 20, 1 << 22, 1 << 24)),
    Level2Primitive("batched_random_memory_access", BATCHED_RANDOM_ACCESS,
                    "sigmoids", _bench_batched_random_access,
                    sizes=(1 << 8, 1 << 10, 1 << 12, 1 << 14, 1 << 16,
                           1 << 18, 1 << 20, 1 << 22, 1 << 24)),
    Level2Primitive("serial_write", SERIAL_WRITE, "linear",
                    _bench_serial_write),
    Level2Primitive("ordered_batch_write", ORDERED_BATCH_WRITE, "linear",
                    _bench_ordered_batch_write),
    Level2Primitive("scattered_batch_write", SCATTERED_BATCH_WRITE,
                    "sigmoids", _bench_scattered_batch_write),
]}

#: default Level-1 -> Level-2 resolution (the synthesizer can override, e.g.
#: rowstore vs columnstore layouts select different scan/search variants).
DEFAULT_RESOLUTION: Dict[str, str] = {
    SCAN: "scalar_scan_columnstore_equal",
    SORTED_SEARCH: "binary_search_columnstore",
    HASH_PROBE: "hash_probe_multiply_shift",
    BLOOM_PROBE: "bloom_probe_multiply_shift",
    SORT: "quicksort",
    RANDOM_ACCESS: "random_memory_access",
    BATCHED_RANDOM_ACCESS: "batched_random_memory_access",
    SERIAL_WRITE: "serial_write",
    ORDERED_BATCH_WRITE: "ordered_batch_write",
    SCATTERED_BATCH_WRITE: "scattered_batch_write",
}


def resolve(level1: str, layout: str = "columnar", op: str = "equal") -> str:
    """Level-1 -> Level-2 resolution with layout/op hints (Figure 5)."""
    if level1 == SCAN:
        if layout == "row-wise":
            return "scalar_scan_rowstore_equal"
        return ("scalar_scan_columnstore_range" if op == "range"
                else "scalar_scan_columnstore_equal")
    if level1 == SORTED_SEARCH:
        return ("binary_search_rowstore" if layout == "row-wise"
                else "binary_search_columnstore")
    return DEFAULT_RESOLUTION[level1]
