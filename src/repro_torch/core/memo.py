"""Thread-safe memo layer for the batch-costing stack.

The costing stack keeps several module-level memos (batchcost's segment /
frontier caches, devicecost's model-name interning and per-profile device
tables, templatecost's statics map).  A long-lived serving process
answers questions from many threads, and the
``functools.lru_cache`` layers are already safe under CPython — but the
insertable dict caches and the interning tables are get-then-put sequences
whose hit/miss accounting (and ``OrderedDict`` recency bookkeeping) can be
corrupted by concurrent callers, and an insert racing ``clear_caches()``
can resurrect a stale entry mid-drain.

This module owns the single re-entrant lock every such memo shares
(``MEMO_LOCK``) plus the :class:`DictCache` built on it.  One lock — not
one per cache — so cross-layer operations (``batchcost.clear_caches()``,
``batchcost.cache_info()``) observe every layer at a consistent point:
no thread can be between a segment-cache put and the matching
frontier-cache put while a clear or info snapshot runs.

The lock guards *bookkeeping*, not computation: cache misses compute
outside the lock, so two threads may redundantly pack the same frontier —
benign (both store equal values) and far cheaper than serializing
synthesis.

Named caches self-register in :data:`REGISTRY` so the cache-key
*invariants* of the stack — hardware appears in no synthesis/packing key,
workload appears in no template-statics key (see
the reference's ``docs/cost_pipeline.md``) — can be asserted by
introspection (walking every registered cache's keys) instead of being
comments that rot.

**Warm-restart snapshots.**  Caches registered with ``snapshot=True``
(the template-statics and packed-segment memos — the expensive,
hardware-free synthesis products) can be persisted to a versioned
on-disk snapshot (:func:`snapshot_caches`) and restored on service start
(:func:`restore_caches`), so a restarted
service answers its first question from warm caches.  The snapshot is keyed by a schema
number plus a fingerprint of the costing stack's source
(:func:`snapshot_version`): any code drift invalidates it and the
restore silently falls back to a cold start — a corrupt, truncated or
stale snapshot must *never* crash ``start()``.  Because Level-2 model
ids are interned lazily in first-use order, the snapshot records the
interning table and restore remaps every id-bearing value through the
live table (cache owners contribute the capture/remap hooks via
:func:`register_snapshot_env` / :func:`register_restore_transform`).
"""
from __future__ import annotations

import collections
import hashlib
import importlib
import os
import pickle
import threading
from typing import Callable, Dict, List, Optional, Tuple

#: the one re-entrant lock shared by every memo in the costing stack
MEMO_LOCK = threading.RLock()

#: named DictCaches, for cache-key introspection (tests, docs tooling);
#: re-registering a name replaces the entry (tests swap caches freely)
REGISTRY: Dict[str, "DictCache"] = {}


def registered_caches() -> Dict[str, "DictCache"]:
    """Snapshot of every named cache currently registered."""
    with MEMO_LOCK:
        return dict(REGISTRY)


CacheInfo = collections.namedtuple("CacheInfo",
                                   "hits misses maxsize currsize")


class DictCache:
    """An insertable memo with lru_cache-style hit/miss accounting.

    ``functools.lru_cache`` cannot be *populated* from outside, but the
    vectorized packer computes many entries per call and must store them
    all; this keeps the same observable counters so cache tests treat
    every layer uniformly.  ``maxsize`` evicts the least-recently-used
    entry (hits refresh recency — a burst of small what-if frontiers
    must not push the retained steady-state search frontier out).

    Every method holds :data:`MEMO_LOCK`, so counters, the recency order
    and ``info()`` snapshots stay consistent under concurrent scoring.
    """

    def __init__(self, maxsize: Optional[int] = None,
                 name: Optional[str] = None,
                 snapshot: bool = False) -> None:
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._maxsize = maxsize
        self._hits = 0
        self._misses = 0
        #: include this cache's entries in warm-restart snapshots
        self.snapshot = snapshot
        if name is not None:
            with MEMO_LOCK:
                REGISTRY[name] = self

    def keys(self) -> List:
        """Snapshot of the current keys (cache-key invariant tests)."""
        with MEMO_LOCK:
            return list(self._data.keys())

    def get(self, key):
        with MEMO_LOCK:
            entry = self._data.get(key)
            if entry is None:
                self._misses += 1
            else:
                self._hits += 1
                self._data.move_to_end(key)
            return entry

    def put(self, key, value) -> None:
        with MEMO_LOCK:
            self._data[key] = value
            if self._maxsize is not None and len(self._data) > self._maxsize:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with MEMO_LOCK:
            self._data.clear()
            self._hits = self._misses = 0

    def discard(self, pred) -> int:
        """Drop every entry with ``pred(key, value)`` true; returns the
        count.  Targeted invalidation for identity-keyed caches (the
        ``device_banks`` replica cache drops a profile's stale replicas
        when its device table rebuilds)."""
        with MEMO_LOCK:
            doomed = [k for k, v in self._data.items() if pred(k, v)]
            for k in doomed:
                del self._data[k]
            return len(doomed)

    def info(self) -> CacheInfo:
        with MEMO_LOCK:
            return CacheInfo(self._hits, self._misses, self._maxsize,
                             len(self._data))

    # -- warm-restart snapshot support ---------------------------------------
    def items(self) -> List[Tuple]:
        """Snapshot of (key, value) pairs, oldest first (LRU order)."""
        with MEMO_LOCK:
            return list(self._data.items())

    def load(self, key, value) -> None:
        """Populate without touching hit/miss counters (snapshot restore)."""
        with MEMO_LOCK:
            self._data[key] = value
            if self._maxsize is not None and len(self._data) > self._maxsize:
                self._data.popitem(last=False)


# ---------------------------------------------------------------------------
# Warm-restart snapshots: persist/restore the snapshot-enabled caches
# ---------------------------------------------------------------------------
#: bump when the snapshot container format itself changes
SNAPSHOT_SCHEMA = 1

#: side-band state captured with a snapshot and rebuilt on restore:
#: name -> (capture_fn() -> picklable, restore_fn(picklable) -> context).
#: The canonical hook is devicecost's lazily-interned model-id table —
#: restore_fn re-interns every recorded name and returns the old-id ->
#: new-id remap that the restore transforms index with.
SNAPSHOT_ENV: Dict[str, Tuple[Callable, Callable]] = {}

#: per-cache value rewrites applied on restore:
#: cache name -> fn(value, env) -> value (env: restored SNAPSHOT_ENV contexts)
RESTORE_TRANSFORMS: Dict[str, Callable] = {}

#: per-cache value rewrites applied at capture time:
#: cache name -> fn(value) -> picklable value.  Cache owners use these to
#: strip live-only state (device-resident array caches and other
#: ``__dict__`` memos) before the value hits the pickle.
CAPTURE_TRANSFORMS: Dict[str, Callable] = {}


def register_snapshot_env(name: str, capture_fn: Callable,
                          restore_fn: Callable) -> None:
    SNAPSHOT_ENV[name] = (capture_fn, restore_fn)


def register_restore_transform(name: str, fn: Callable) -> None:
    RESTORE_TRANSFORMS[name] = fn


def register_capture_transform(name: str, fn: Callable) -> None:
    CAPTURE_TRANSFORMS[name] = fn


#: source files whose drift invalidates a snapshot — every module that
#: defines a snapshotted cache's key or value types, or the model-id
#: interning the values index into
_FINGERPRINT_MODULES = (
    "repro_torch.core.access", "repro_torch.core.batchcost", "repro_torch.core.devicecost",
    "repro_torch.core.elements", "repro_torch.core.memo", "repro_torch.core.primitives",
    "repro_torch.core.synthesis", "repro_torch.core.templatecost",
)


def snapshot_version() -> str:
    """``"<schema>:<source fingerprint>"`` — the compatibility key.

    The fingerprint hashes the source of every module that shapes
    snapshot keys/values, so a code change that could make pickled
    entries wrong (not merely suboptimal) turns restore into a no-op
    cold start instead of a silent corruption."""
    digest = hashlib.sha256()
    for modname in _FINGERPRINT_MODULES:
        try:
            mod = importlib.import_module(modname)
            with open(mod.__file__, "rb") as fh:
                digest.update(fh.read())
        except Exception:
            digest.update(f"missing:{modname}".encode())
    return f"{SNAPSHOT_SCHEMA}:{digest.hexdigest()[:16]}"


def snapshot_caches(path: str) -> int:
    """Persist every snapshot-enabled cache to ``path`` (atomically).

    Returns the number of entries written.  The write goes through a
    sibling temp file + ``os.replace`` so a crash mid-dump never leaves
    a truncated snapshot where a good one stood."""
    with MEMO_LOCK:
        caches = {}
        for name, cache in REGISTRY.items():
            if not cache.snapshot:
                continue
            strip = CAPTURE_TRANSFORMS.get(name)
            items = cache.items()
            if strip is not None:
                items = [(key, strip(value)) for key, value in items]
            caches[name] = items
        env = {name: capture() for name, (capture, _) in
               SNAPSHOT_ENV.items()}
    payload = {"version": snapshot_version(), "env": env, "caches": caches}
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return sum(len(items) for items in caches.values())


#: a restore attempt's entry count plus *why* it went the way it did:
#: ``restored`` / ``empty`` (valid snapshot, nothing to load) succeed;
#: ``missing`` / ``corrupt`` (unreadable or failed env rebuild) /
#: ``stale`` (version mismatch) / ``error`` (torn mid-restore, caches
#: cleared) all cold-start with 0 entries
RestoreReport = collections.namedtuple("RestoreReport", "entries outcome")


def restore_caches_report(path: str) -> RestoreReport:
    """Load a snapshot into the registered caches; never raises.

    Missing file, truncated pickle, schema/fingerprint mismatch, or a
    value that no longer remaps — every failure path quietly cold-starts
    with 0 entries, but the :class:`RestoreReport` outcome says *which*
    failure it was, so the serving tier can count and log discarded
    snapshots instead of silently eating them (a service ``start()``
    must still never die on a bad snapshot).  Partially-restored caches
    are cleared before an ``error`` return so a torn restore cannot
    leave inconsistent warm state."""
    from repro_torch.testing import faults    # no cycle: faults is stdlib+numpy
    try:
        faults.check("memo.restore")
        with open(path, "rb") as fh:
            payload = pickle.load(fh)
    except FileNotFoundError:
        return RestoreReport(0, "missing")
    except Exception:
        return RestoreReport(0, "corrupt")
    try:
        if payload.get("version") != snapshot_version():
            return RestoreReport(0, "stale")
        env = {}
        for name, data in payload.get("env", {}).items():
            if name in SNAPSHOT_ENV:
                env[name] = SNAPSHOT_ENV[name][1](data)
    except Exception:
        return RestoreReport(0, "corrupt")
    restored = 0
    touched: List[DictCache] = []
    try:
        with MEMO_LOCK:
            for name, items in payload.get("caches", {}).items():
                cache = REGISTRY.get(name)
                if cache is None or not cache.snapshot:
                    continue
                transform = RESTORE_TRANSFORMS.get(name)
                touched.append(cache)
                for key, value in items:
                    if transform is not None:
                        value = transform(value, env)
                    cache.load(key, value)
                    restored += 1
        return RestoreReport(restored, "restored" if restored else "empty")
    except Exception:
        with MEMO_LOCK:       # a torn restore must not leave partial state
            for cache in touched:
                cache.clear()
        return RestoreReport(0, "error")


def restore_caches(path: str) -> int:
    """:func:`restore_caches_report` for callers that only want the
    entry count (0 on any failure, preserving the pre-report contract)."""
    return restore_caches_report(path).entries
