"""Ground-truth data structure implementations (paper §5 baselines).

The paper validates synthesized costs against full C++ implementations of
eight access methods.  These are the equivalent implementations for this
container's hardware profile: Array, Sorted Array, Linked-list, Range
Partitioned Linked-list, Skip-list, Trie, Hash-table, B+tree (plus CSB+tree
as a contiguous-children variant).  They are deliberately written in the
same flat-array style the paper's Level-2 benchmarks measure (numpy arrays,
explicit per-node scans/searches) so that measured latencies decompose into
the same access primitives the synthesizer reasons about.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Structure:
    """Interface: bulk_load, get, range_get, update."""

    name = "abstract"

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        raise NotImplementedError

    def get(self, key: int) -> Optional[int]:
        raise NotImplementedError

    def range_get(self, lo: int, hi: int) -> List[int]:
        raise NotImplementedError

    def update(self, key: int, value: int) -> bool:
        """Paper's updates: a point query plus one write access."""
        raise NotImplementedError


class Array(Structure):
    """UDP with capacity = #puts: full scan on reads, append writes."""

    name = "array"

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        self.keys = np.ascontiguousarray(keys)
        self.values = np.ascontiguousarray(values)

    def get(self, key: int) -> Optional[int]:
        idx = np.flatnonzero(self.keys == key)
        return int(self.values[idx[0]]) if idx.size else None

    def range_get(self, lo: int, hi: int) -> List[int]:
        mask = (self.keys >= lo) & (self.keys < hi)
        return self.values[mask].tolist()

    def update(self, key: int, value: int) -> bool:
        idx = np.flatnonzero(self.keys == key)
        if not idx.size:
            return False
        self.values[idx[0]] = value
        return True


class SortedArray(Structure):
    """ODP with capacity = #puts: binary search reads, sort on load."""

    name = "sorted_array"

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        order = np.argsort(keys, kind="quicksort")
        self.keys = np.ascontiguousarray(keys[order])
        self.values = np.ascontiguousarray(values[order])

    def _locate(self, key: int) -> Optional[int]:
        idx = int(np.searchsorted(self.keys, key))
        if idx < self.keys.size and self.keys[idx] == key:
            return idx
        return None

    def get(self, key: int) -> Optional[int]:
        idx = self._locate(key)
        return int(self.values[idx]) if idx is not None else None

    def range_get(self, lo: int, hi: int) -> List[int]:
        left = int(np.searchsorted(self.keys, lo, side="left"))
        right = int(np.searchsorted(self.keys, hi, side="left"))
        return self.values[left:right].tolist()

    def update(self, key: int, value: int) -> bool:
        idx = self._locate(key)
        if idx is None:
            return False
        self.values[idx] = value
        return True


class LinkedList(Structure):
    """LL -> UDP: list of unsorted fixed-capacity pages, scanned in order."""

    name = "linked_list"

    def __init__(self, page_capacity: int = 256):
        self.page_capacity = page_capacity

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        cap = self.page_capacity
        self.pages: List[Tuple[np.ndarray, np.ndarray]] = [
            (keys[i:i + cap].copy(), values[i:i + cap].copy())
            for i in range(0, len(keys), cap)]

    def get(self, key: int) -> Optional[int]:
        for page_keys, page_values in self.pages:
            idx = np.flatnonzero(page_keys == key)
            if idx.size:
                return int(page_values[idx[0]])
        return None

    def range_get(self, lo: int, hi: int) -> List[int]:
        out: List[int] = []
        for page_keys, page_values in self.pages:
            mask = (page_keys >= lo) & (page_keys < hi)
            out.extend(page_values[mask].tolist())
        return out

    def update(self, key: int, value: int) -> bool:
        for page_keys, page_values in self.pages:
            idx = np.flatnonzero(page_keys == key)
            if idx.size:
                page_values[idx[0]] = value
                return True
        return False


class RangePartitionedLinkedList(Structure):
    """Range -> LL -> UDP: fixed range partitions, each a linked list."""

    name = "range_partitioned_linked_list"

    def __init__(self, partitions: int = 100, page_capacity: int = 256):
        self.partitions = partitions
        self.page_capacity = page_capacity

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        self.lo = int(keys.min()) if len(keys) else 0
        self.hi = int(keys.max()) + 1 if len(keys) else 1
        self.width = max((self.hi - self.lo) // self.partitions, 1)
        self.lists = [LinkedList(self.page_capacity)
                      for _ in range(self.partitions)]
        part = np.minimum((keys - self.lo) // self.width, self.partitions - 1)
        for p in range(self.partitions):
            mask = part == p
            self.lists[p].bulk_load(keys[mask], values[mask])

    def _part(self, key: int) -> int:
        return min(max((key - self.lo) // self.width, 0), self.partitions - 1)

    def get(self, key: int) -> Optional[int]:
        return self.lists[self._part(key)].get(key)

    def range_get(self, lo: int, hi: int) -> List[int]:
        out: List[int] = []
        for p in range(self._part(lo), self._part(max(hi - 1, lo)) + 1):
            out.extend(self.lists[p].range_get(lo, hi))
        return out

    def update(self, key: int, value: int) -> bool:
        return self.lists[self._part(key)].update(key, value)


class SkipList(Structure):
    """SL -> UDP: pages with zone maps and perfect skip links.

    Perfect skip links permit binary-search-style navigation over the page
    zone maps; inside the target page a binary search over sorted page keys.
    """

    name = "skip_list"

    def __init__(self, page_capacity: int = 256):
        self.page_capacity = page_capacity

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        order = np.argsort(keys, kind="quicksort")
        keys, values = keys[order], values[order]
        cap = self.page_capacity
        self.pages = [(keys[i:i + cap].copy(), values[i:i + cap].copy())
                      for i in range(0, len(keys), cap)]
        self.page_min = np.array([p[0][0] for p in self.pages]) \
            if self.pages else np.zeros(0, dtype=keys.dtype)

    def _page_for(self, key: int) -> int:
        return max(int(np.searchsorted(self.page_min, key, side="right")) - 1, 0)

    def get(self, key: int) -> Optional[int]:
        if not self.pages:
            return None
        page_keys, page_values = self.pages[self._page_for(key)]
        idx = int(np.searchsorted(page_keys, key))
        if idx < page_keys.size and page_keys[idx] == key:
            return int(page_values[idx])
        return None

    def range_get(self, lo: int, hi: int) -> List[int]:
        out: List[int] = []
        for p in range(self._page_for(lo), len(self.pages)):
            page_keys, page_values = self.pages[p]
            if page_keys[0] >= hi:
                break
            mask = (page_keys >= lo) & (page_keys < hi)
            out.extend(page_values[mask].tolist())
        return out

    def update(self, key: int, value: int) -> bool:
        if not self.pages:
            return False
        page_keys, page_values = self.pages[self._page_for(key)]
        idx = int(np.searchsorted(page_keys, key))
        if idx < page_keys.size and page_keys[idx] == key:
            page_values[idx] = value
            return True
        return False


class Trie(Structure):
    """Trie -> UDP: radix-256 partitioning on key bytes, UDP leaves."""

    name = "trie"

    def __init__(self, radix_bits: int = 8, max_depth: int = 4,
                 page_capacity: int = 256):
        self.radix_bits = radix_bits
        self.max_depth = max_depth
        self.page_capacity = page_capacity

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        self.root: Dict = {}
        shift_total = self.radix_bits * self.max_depth
        for key, value in zip(keys.tolist(), values.tolist()):
            node = self.root
            for level in range(self.max_depth - 1):
                shift = shift_total - self.radix_bits * (level + 1)
                byte = (key >> shift) & ((1 << self.radix_bits) - 1)
                node = node.setdefault(byte, {})
            byte = key & ((1 << self.radix_bits) - 1)
            node.setdefault(byte, []).append((key, value))

    def _walk(self, key: int):
        node = self.root
        shift_total = self.radix_bits * self.max_depth
        for level in range(self.max_depth - 1):
            shift = shift_total - self.radix_bits * (level + 1)
            byte = (key >> shift) & ((1 << self.radix_bits) - 1)
            node = node.get(byte)
            if node is None:
                return None
        return node.get(key & ((1 << self.radix_bits) - 1))

    def get(self, key: int) -> Optional[int]:
        leaf = self._walk(key)
        if leaf is None:
            return None
        for k, v in leaf:  # serial scan of the target page
            if k == key:
                return v
        return None

    def range_get(self, lo: int, hi: int) -> List[int]:
        out: List[int] = []

        def recurse(node, depth):
            if isinstance(node, list):
                out.extend(v for k, v in node if lo <= k < hi)
                return
            for byte in sorted(node):
                recurse(node[byte], depth + 1)

        recurse(self.root, 0)
        return out

    def update(self, key: int, value: int) -> bool:
        leaf = self._walk(key)
        if leaf is None:
            return False
        for i, (k, _) in enumerate(leaf):
            if k == key:
                leaf[i] = (key, value)
                return True
        return False


class HashTable(Structure):
    """Hash -> LL -> UDP: modulo buckets, small unsorted pages per bucket."""

    name = "hash_table"

    def __init__(self, buckets: int = 100, page_capacity: int = 5):
        self.buckets = buckets
        self.page_capacity = page_capacity

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        self.table: List[LinkedList] = [LinkedList(self.page_capacity)
                                        for _ in range(self.buckets)]
        bucket = keys % self.buckets
        for b in range(self.buckets):
            mask = bucket == b
            self.table[b].bulk_load(keys[mask], values[mask])

    def get(self, key: int) -> Optional[int]:
        return self.table[key % self.buckets].get(key)

    def range_get(self, lo: int, hi: int) -> List[int]:
        out: List[int] = []
        for ll in self.table:
            out.extend(ll.range_get(lo, hi))
        return out

    def update(self, key: int, value: int) -> bool:
        return self.table[key % self.buckets].update(key, value)


class BPlusTree(Structure):
    """B+ -> ... -> B+ -> ODP with fixed fanout and sorted leaf pages."""

    name = "btree"

    def __init__(self, fanout: int = 20, page_capacity: int = 256):
        self.fanout = fanout
        self.page_capacity = page_capacity

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        order = np.argsort(keys, kind="quicksort")
        keys, values = keys[order], values[order]
        cap = self.page_capacity
        self.leaf_keys = [keys[i:i + cap].copy()
                          for i in range(0, len(keys), cap)]
        self.leaf_values = [values[i:i + cap].copy()
                            for i in range(0, len(keys), cap)]
        # build internal levels of fences bottom-up
        fences = np.array([k[0] for k in self.leaf_keys]) \
            if self.leaf_keys else np.zeros(0, dtype=keys.dtype)
        self.levels: List[List[np.ndarray]] = []  # top level last
        level = [fences[i:i + self.fanout]
                 for i in range(0, len(fences), self.fanout)]
        while len(level) > 1:
            self.levels.append(level)
            fences = np.array([node[0] for node in level])
            level = [fences[i:i + self.fanout]
                     for i in range(0, len(fences), self.fanout)]
        self.levels.append(level)
        self.levels.reverse()  # root first

    def _leaf_for(self, key: int) -> int:
        node_idx = 0
        for level in self.levels:
            node = level[node_idx]
            # binary search through fences within the node
            child = max(int(np.searchsorted(node, key, side="right")) - 1, 0)
            node_idx = node_idx * self.fanout + child
        return min(node_idx, len(self.leaf_keys) - 1)

    def get(self, key: int) -> Optional[int]:
        if not self.leaf_keys:
            return None
        leaf = self._leaf_for(key)
        page_keys = self.leaf_keys[leaf]
        idx = int(np.searchsorted(page_keys, key))
        if idx < page_keys.size and page_keys[idx] == key:
            return int(self.leaf_values[leaf][idx])
        return None

    def range_get(self, lo: int, hi: int) -> List[int]:
        if not self.leaf_keys:
            return []
        out: List[int] = []
        for leaf in range(self._leaf_for(lo), len(self.leaf_keys)):
            page_keys = self.leaf_keys[leaf]
            if page_keys[0] >= hi:
                break
            mask = (page_keys >= lo) & (page_keys < hi)
            out.extend(self.leaf_values[leaf][mask].tolist())
        return out

    def update(self, key: int, value: int) -> bool:
        if not self.leaf_keys:
            return False
        leaf = self._leaf_for(key)
        page_keys = self.leaf_keys[leaf]
        idx = int(np.searchsorted(page_keys, key))
        if idx < page_keys.size and page_keys[idx] == key:
            self.leaf_values[leaf][idx] = value
            return True
        return False


class CSBTree(BPlusTree):
    """Cache-conscious B+tree: contiguous (BFS) children arrays.

    Fences of each level live in one contiguous array; children are found by
    arithmetic offset (no per-child pointers), the Rao & Ross "Full" design.
    """

    name = "csb_tree"

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        super().bulk_load(keys, values)
        # consolidate each level into one contiguous array + node offsets
        self.flat_levels = []
        for level in self.levels:
            flat = np.concatenate(level) if level else np.zeros(0)
            offsets = np.cumsum([0] + [len(n) for n in level])
            self.flat_levels.append((flat, offsets))

    def _leaf_for(self, key: int) -> int:
        node_idx = 0
        for flat, offsets in self.flat_levels:
            lo, hi = offsets[node_idx], offsets[node_idx + 1]
            child = max(int(np.searchsorted(flat[lo:hi], key, side="right")) - 1, 0)
            node_idx = node_idx * self.fanout + child
        return min(node_idx, len(self.leaf_keys) - 1)


ALL_STRUCTURES = {
    "array": Array,
    "sorted_array": SortedArray,
    "linked_list": LinkedList,
    "range_partitioned_linked_list": RangePartitionedLinkedList,
    "skip_list": SkipList,
    "trie": Trie,
    "hash_table": HashTable,
    "btree": BPlusTree,
    "csb_tree": CSBTree,
}


def measure_workload(structure: Structure, keys: np.ndarray,
                     values: np.ndarray, queries: Sequence[int],
                     op: str = "get") -> Dict[str, float]:
    """Bulk load then run a query workload; return per-op latencies (sec)."""
    t0 = time.perf_counter()
    structure.bulk_load(keys, values)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    if op == "get":
        for q in queries:
            structure.get(int(q))
    elif op == "range":
        for q in queries:
            structure.range_get(int(q), int(q) + 1000)
    elif op == "update":
        for q in queries:
            structure.update(int(q), 0)
    else:
        raise ValueError(op)
    t_query = time.perf_counter() - t0
    return {"bulk_load_s": t_load,
            "per_query_s": t_query / max(len(queries), 1)}
