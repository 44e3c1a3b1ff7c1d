"""The design of kernel K1 (``src/repro_torch/csrc/sorted_search.cu``),
emulated step by step in numpy and held against ``np.searchsorted``.

The kernel cannot run on the CPU, so this is what holds its algorithm
here: the top tree in BFS (Eytzinger) order at depth L (as its first
launch writes it and the search reads it from shared memory), kGroup
searches a thread walks in lockstep (threads past the end search for 0),
the levels between the tree and the window, and the window count over the
aligned 16-byte chunks that cover the window (or over the window itself,
the scalar variant for keys without 16-byte alignment).  Every load is
checked to lie inside the keys; Get's ``keys[rank - 1]`` must lie in the
window.  The constants are the kernel's, and a test reads them from its
source.
"""
from __future__ import annotations

import math
import pathlib
import re

import numpy as np
import pytest

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" /
          "repro_torch" / "csrc" / "sorted_search.cu")

THREADS, TREE_BYTES, WINDOW_BYTES = 1024, 128 * 1024, 64


def group(itemsize: int) -> int:
    """The searches a thread walks (``Group<K>::kQueries``): 4 of 4-byte
    keys, 2 of int64."""
    return 16 // itemsize
DTYPES = [np.int32, np.int64, np.float32]


def max_top(itemsize: int) -> int:
    """The deepest tree of 2^L keys that fits TREE_BYTES: 15 levels of
    4-byte keys, 14 of int64."""
    return (TREE_BYTES // itemsize).bit_length() - 1


def search_levels(n: int) -> int:
    levels, length = 0, n
    while length > 1:
        length -= length >> 1
        levels += 1
    return levels


def build_tree(keys: np.ndarray, top: int) -> np.ndarray:
    """Node i (root 1) at level l holds keys[base + half_l], base the sum
    of half_j over the right turns j < l spelled by i's lower bits; slot 0
    holds 0.  (All nodes at once, one level of their paths a step.)"""
    n = len(keys)
    tree = np.zeros(1 << top, keys.dtype)
    node = np.arange(1, 1 << top, dtype=np.int64)
    level = np.floor(np.log2(node)).astype(np.int64)
    pos = np.zeros(len(node), np.int64)
    length = n
    for j in range(top):
        half = length >> 1
        deeper = level > j                 # the path turns at level j
        turn = (node >> np.maximum(level - 1 - j, 0)) & 1
        pos += np.where(deeper & (turn == 1), half, 0)
        at = level == j                    # the node probes at level j
        pos[at] += half
        length -= half
    tree[1:] = _load(keys, pos)
    return tree


def _load(keys: np.ndarray, idx: np.ndarray) -> np.ndarray:
    assert (idx >= 0).all() and (idx < len(keys)).all(), "load out of bounds"
    return keys[idx]


def kernel_search(keys: np.ndarray, queries: np.ndarray, vec: bool = True,
                  top_cap: int = None):
    """(rank, hit, window base, window len) per query, as the kernel
    computes them; tiles of THREADS x group queries, [group, THREADS]
    lanes in lockstep."""
    n = len(keys)
    cap = max_top(keys.itemsize) if top_cap is None else top_cap
    top = min(cap, search_levels(n))
    tree = build_tree(keys, top)
    per_thread = group(keys.itemsize)
    tile = THREADS * per_thread
    n_tiles = -(-len(queries) // tile)
    x = np.zeros(n_tiles * tile, keys.dtype)       # past the end: K(0)
    x[: len(queries)] = queries
    x = x.reshape(n_tiles, per_thread, THREADS)
    base = np.zeros(x.shape, np.int64)
    node = np.ones(x.shape, np.int64)
    length = n
    for _ in range(top):
        half = length >> 1
        right = (tree[node] <= x).astype(np.int64)
        base += right * half
        node = 2 * node + right
        length -= half
    # the scalar window (keys off 16-byte alignment) is half as wide
    window = (WINDOW_BYTES if vec else WINDOW_BYTES // 2) // keys.itemsize
    while length > window:
        half = length >> 1
        probe = _load(keys, base + half)        # group loads, then compares
        base += np.where(probe <= x, half, 0)
        length -= half
    if vec:
        per = 16 // keys.itemsize
        chunks = (window - 1) // per + 2
        first = base // per
        last = (base + length - 1) // per
        count = np.zeros(x.shape, np.int64)
        hit = np.zeros(x.shape, bool)
        for j in range(chunks):
            at = first + j
            for e in range(per):
                i = at * per + e
                valid = (at <= last) & (i < n)
                k = np.zeros(x.shape, keys.dtype)
                k[valid] = _load(keys, i[valid])
                count += valid & (k <= x)
                hit |= valid & (k == x)
        rank = first * per + count
    else:
        count = np.zeros(x.shape, np.int64)
        hit = np.zeros(x.shape, bool)
        for j in range(length):
            k = _load(keys, base + j)
            count += k <= x
            hit |= k == x
        rank = base + count
    q = len(queries)
    return (rank.reshape(-1)[:q], hit.reshape(-1)[:q], base.reshape(-1)[:q],
            length)


def _check(keys: np.ndarray, queries: np.ndarray, vec: bool,
           top_cap: int = None) -> None:
    keys = np.asarray(keys)
    queries = np.asarray(queries, keys.dtype)
    n = len(keys)
    rank, hit, base, length = kernel_search(keys, queries, vec, top_cap)
    want = np.minimum(np.searchsorted(keys, queries, side="right"), n)
    np.testing.assert_array_equal(rank, want)
    # Get: keys[clip(rank - 1)] lies in the window, and the window's
    # equality test is the reference's found mask
    idx = np.clip(rank - 1, 0, n - 1)
    assert ((base <= idx) & (idx < base + length)).all()
    np.testing.assert_array_equal(hit, keys[idx] == queries)


def _queries(rng, lo, hi, dtype, q) -> np.ndarray:
    info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
    extremes = [info.min, info.max, lo - 1, hi + 1]
    if dtype == np.float32:
        extremes += [-np.inf, np.inf, -0.0, 0.0]
    return np.concatenate([rng.integers(lo - 2, hi + 3, q).astype(dtype),
                           np.asarray(extremes, dtype)])


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("top_cap", [None, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_small_n_with_duplicates(dtype, top_cap, vec):
    """N = 1..300 over small key ranges (long runs of duplicates); with
    the tree cut to 2 levels too, so small N also reach the middle levels
    and windows longer than one key."""
    rng = np.random.default_rng(7)
    for n in range(1, 301):
        hi = max(1, n // 8)
        keys = np.sort(rng.integers(0, hi + 1, n)).astype(dtype)
        queries = np.concatenate([np.arange(-2, hi + 3).astype(dtype),
                                  _queries(rng, 0, hi, dtype, 64)])
        _check(keys, queries, vec, top_cap)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_around_the_tree_depth(dtype, offset, vec):
    """N just below, at and just above 2^L: the tree covers every level,
    or all but one (the window then holds 1 or 2 keys)."""
    n = 2 ** max_top(np.dtype(dtype).itemsize) + offset
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 3 * n, n)).astype(dtype)
    queries = np.concatenate([keys[rng.integers(0, n, 3000)],
                              _queries(rng, 0, 3 * n, dtype, 3000)])
    _check(keys, queries, vec)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n", [4097, 40_000, 300_001, 1_000_003])
@pytest.mark.parametrize("dtype", DTYPES)
def test_large_n_with_duplicates(dtype, n, vec):
    """N from the window-only range to large enough for the middle
    levels, keys with duplicates."""
    rng = np.random.default_rng(n)
    hi = 3 * n
    keys = np.sort(rng.integers(0, hi, n)).astype(dtype)
    queries = np.concatenate([keys[rng.integers(0, n, 3000)],
                              _queries(rng, 0, hi, dtype, 3000)])
    _check(keys, queries, vec)


@pytest.mark.parametrize("dtype", DTYPES)
def test_long_runs_and_extremes(dtype):
    """A few distinct keys in runs of thousands, the dtype's maximum as a
    key, and queries equal to it."""
    info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
    runs = [(-5, 3000), (0, 1), (7, 5000), (8, 4096), (info.max, 33)]
    keys = np.concatenate([np.full(c, v, dtype) for v, c in runs])
    queries = np.asarray([-6, -5, -1, 0, 1, 6, 7, 8, 9, info.max,
                          info.min], dtype)
    for vec in (True, False):
        _check(keys, queries, vec)
        _check(keys[:33], queries, vec)


def test_float_signed_zero_and_infinities():
    keys = np.asarray([-np.inf, -1.0, -0.0, 0.0, 0.0, 2.5, np.inf],
                      np.float32)
    queries = np.asarray([-np.inf, -0.0, 0.0, np.inf, 3.0, -2.0],
                         np.float32)
    for vec in (True, False):
        _check(keys, queries, vec)
        _check(keys[1:], queries, vec)


def test_tree_is_the_first_levels_of_the_loop():
    """The tree's nodes are exactly the positions the branchless loop
    probes over its first L levels."""
    rng = np.random.default_rng(3)
    n = 100_003
    keys = np.arange(n, dtype=np.int64)         # key == position
    top = max_top(keys.itemsize)
    tree = build_tree(keys, top)
    queries = rng.integers(-1, n + 1, 5000)
    base = np.zeros(len(queries), np.int64)
    node = np.ones(len(queries), np.int64)
    length = n
    for _ in range(top):
        half = length >> 1
        np.testing.assert_array_equal(tree[node], base + half)
        right = (keys[base + half] <= queries).astype(np.int64)
        base += right * half
        node = 2 * node + right
        length -= half


@pytest.mark.parametrize("name,value,pattern", [
    ("threads", THREADS, r"constexpr int kThreads = (.+);"),
    ("tree bytes", TREE_BYTES, r"constexpr int kTreeBytes = (.+?);"),
    ("window bytes", WINDOW_BYTES, r"constexpr int kWindowBytes = (.+);"),
    ("queries a thread", "16 / sizeof(K)",
     r"static constexpr int kQueries = (.+);")])
def test_constants_are_the_kernels(name, value, pattern):
    """The emulation's constants as the kernel's source spells them."""
    found = re.findall(pattern, SOURCE.read_text())
    assert len(found) == 1, f"{name}: {found}"
    spelled = found[0].strip()
    if isinstance(value, int):          # a product of integers
        spelled = math.prod(int(f) for f in spelled.split("*"))
    assert spelled == value, f"{name}: {spelled}"
