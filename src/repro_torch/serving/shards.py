"""Scoring-shard pool: one window's fused scoring, routed across slots.

The port's twin of the reference's ``serving/shards.py``.
:class:`~repro_torch.serving.service.DesignCalculatorService` coalesces
a window into one spliced scoring product per (hardware profile,
sweep-point axis) group.  :class:`ScoringShardPool` is the routing layer
in between: it partitions each group's product into contiguous slices
(:meth:`~repro_torch.core.batchcost.PackedFrontier.split` segment ranges
for flat frontiers, :meth:`~repro_torch.core.batchcost.PackedSweep.split`
design ranges for sweeps), dispatches every partition's fused call (one
launch of kernel K0) onto its own **slot** from a dedicated thread, and
merges the partition totals back into the single grid the worker slices
per request.

Slots, not local devices.  The reference takes ``jax.local_devices()``;
the pool here takes ``devices=``, a sequence of torch devices (by
default every visible ``cuda:i`` when the runtime device is CUDA, else
the runtime device alone), clamped by ``n_shards``.  A slot is an index
into that list, and two slots may name the same device: two slots of
``cuda:0`` split a window on one card, and ``["cpu"] * n`` stands in for
the reference's forced host devices in the CPU tests.  Each CUDA slot
dispatches on a ``torch.cuda.Stream`` of its own.  Layouts and bank
replicas are memoized per device and read from every slot's stream, so
the stream that builds one is drained before it is published, and K0
records its inputs on a slot's stream
(:mod:`repro_torch.core.devicecost`).

Merged results are **bit-identical** to the unsharded call: partitions
cut on tile-aligned segment / design boundaries, and K0 reduces every
design's records in one pass from its first record whatever the layout
(asserted in ``tests/test_torch_sharded.py``).

Deadline composition: the worker passes a ``before_dispatch`` probe that
runs *between* shard dispatches — deadlines are checked between scoring
calls, and between the shards of one call.  When the probe reports
nothing left alive, remaining dispatches are skipped and the group
returns ``None``.

Self-healing.  A hung or failed part must cost one part, not the window:

* every part-wait carries a **deadline-derived timeout** (the window's
  furthest-out owner deadline, bounded by ``part_timeout_s`` always);
* a failed / non-finite part gets **one bounded retry on a different
  slot**; a *timed-out* part instead races a **hedged duplicate** on a
  different slot against the original — first acceptable result wins;
* slots accrue **consecutive-failure counts**; at ``quarantine_after``
  the slot is quarantined for ``quarantine_s`` (routed around), then
  **half-open**: the next pick is a probe whose success closes the
  breaker and whose failure re-opens it;
* a part that exhausts its retries gets a **last-resort flat in-thread
  rescore** before the group is declared dead;
* timed-out parts cannot be cancelled — they are **abandoned and
  accounted** (``abandoned_parts``), and the executor is replaced when
  wedged threads exhaust its capacity.

Faults are injected at the ``shards.dispatch`` seam
(:mod:`repro_torch.testing.faults`, keyed by slot index); with no plan
active the steady-state dispatch path is unchanged.  One slot, no
deadline and no active plan: the pool calls ``packed.score`` in its own
thread — no executor hop, no extra launch.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import devicecost
from repro_torch.core.batchcost import PackedFrontier, PackedSweep
from repro_torch.core.hardware import HardwareProfile
from repro_torch.testing import faults

#: below this many cells per partition, splitting costs more dispatch
#: overhead than it recovers — one shard serves the whole product
DEFAULT_MIN_CELLS_PER_SHARD = 4096

#: hard upper bound on any one part-wait when no window deadline exists —
#: "a hung device call blocks the worker loop forever" must be impossible
DEFAULT_PART_TIMEOUT_S = 60.0


class ShardTimeout(TimeoutError):
    """One partition's device call exceeded its deadline-derived timeout."""

    def __init__(self, message: str, *, part: int,
                 timeout_s: float) -> None:
        super().__init__(message)
        self.part = part
        self.timeout_s = timeout_s


class NonFiniteScore(RuntimeError):
    """A scoring call produced non-finite totals (corrupt banks or a
    device fault) — caught by the serving tier's engine-fallback chain,
    never surfaced to a client."""


def _swallow(future) -> None:
    """Done-callback for abandoned parts: retrieve and drop the outcome."""
    try:
        future.exception()
    except Exception:
        pass


class ScoringShardPool:
    """Partition, dispatch, heal and merge one scoring product across
    slots (see module docstring).

    ``devices`` lists the slots' devices (default
    :func:`repro_torch.core.devicecost.shard_devices`; a device may
    repeat); ``n_shards=None``
    takes every slot, an explicit count is clamped to ``[1,
    len(devices)]``.  With one slot — and no deadline or active fault
    plan — the pool degenerates to a plain in-thread ``packed.score``
    call on that slot's device: no executor hop.  A window deadline or
    an active :class:`~repro_torch.testing.faults.FaultPlan` routes even
    a single part through the executor so the timeout / retry / rescore
    machinery applies.
    """

    def __init__(self, n_shards: Optional[int] = None, *,
                 devices: Optional[Sequence[runtime.DeviceLike]] = None,
                 min_cells_per_shard: int = DEFAULT_MIN_CELLS_PER_SHARD,
                 part_timeout_s: float = DEFAULT_PART_TIMEOUT_S,
                 retries: int = 1,
                 quarantine_after: int = 3,
                 quarantine_s: float = 30.0) -> None:
        devices = list(devicecost.shard_devices()) if devices is None \
            else [devicecost.resolve(d) for d in devices]
        if not devices:
            raise ValueError("a scoring-shard pool needs at least one "
                             "device")
        wanted = len(devices) if n_shards is None else int(n_shards)
        self.devices = devices[:max(min(wanted, len(devices)), 1)]
        self.n_shards = len(self.devices)
        #: each CUDA slot's own stream (None on the CPU)
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self.min_cells_per_shard = max(int(min_cells_per_shard), 1)
        self.part_timeout_s = float(part_timeout_s)
        self.retries = max(int(retries), 0)
        self.quarantine_after = max(int(quarantine_after), 1)
        self.quarantine_s = float(quarantine_s)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "shard_timeouts": 0, "abandoned_parts": 0,
            "shard_retries": 0, "shard_rescored": 0,
            "shard_nonfinite": 0, "device_quarantines": 0,
            "device_probes": 0, "device_recoveries": 0}
        #: recent healing events, newest last: ("retry", part, from_dev,
        #: to_dev) / ("quarantine"|"probe"|"recover", dev) — test and
        #: health() visibility into routing decisions
        self.events: "collections.deque" = collections.deque(maxlen=64)
        #: consecutive failures + breaker state per device
        self._state = [{"fails": 0, "open_until": 0.0}
                       for _ in self.devices]
        # headroom beyond one thread per device: retries need a free
        # thread while the original part is still in flight, and every
        # abandoned (timed-out, uncancellable) part wedges a thread for
        # as long as its device call runs — too little slack funnels the
        # healthy dispatch stream behind casualties, and the queue wait
        # then trips part timeouts on parts that never even started
        self._workers = self.n_shards + 3
        self._lost = 0        # executor threads wedged behind abandoned parts
        self._epoch = 0       # bumped when the executor is replaced
        self._pool = ThreadPoolExecutor(
            max_workers=self._workers, thread_name_prefix="scoring-shard")

    # -- observability ------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Snapshot of the pool's failure-handling counters."""
        with self._lock:
            return dict(self._counters)

    def device_health(self) -> List[Dict]:
        """Per-slot breaker state: ``ok`` / ``quarantined`` (routed
        around) / ``half-open`` (next pick is a probe)."""
        now = time.monotonic()
        out = []
        with self._lock:
            for slot, (device, st) in enumerate(zip(self.devices,
                                                    self._state)):
                if st["fails"] < self.quarantine_after:
                    state = "ok"
                elif st["open_until"] > now:
                    state = "quarantined"
                else:
                    state = "half-open"
                out.append({"slot": slot, "device": str(device),
                            "state": state,
                            "consecutive_failures": st["fails"],
                            "reopen_in_s": max(st["open_until"] - now,
                                               0.0)})
        return out

    def recent_events(self) -> List[Tuple]:
        with self._lock:
            return list(self.events)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] += n

    # -- device breaker bookkeeping -----------------------------------------
    def _device_ok(self, dev: int) -> None:
        with self._lock:
            st = self._state[dev]
            if st["fails"] >= self.quarantine_after:
                self._counters["device_recoveries"] += 1
                self.events.append(("recover", dev))
            st["fails"] = 0
            st["open_until"] = 0.0

    def _device_fail(self, dev: int) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._state[dev]
            st["fails"] += 1
            if st["fails"] >= self.quarantine_after \
                    and st["open_until"] <= now:
                st["open_until"] = now + self.quarantine_s
                self._counters["device_quarantines"] += 1
                self.events.append(("quarantine", dev))

    def _pick_device(self, i: int, exclude: Tuple[int, ...] = ()) -> int:
        """Round-robin from ``i`` over healthy devices; quarantined ones
        are routed around until their window lapses, at which point the
        first pick is a half-open probe.  Falls back to the least-bad
        device when everything is excluded or quarantined (scoring must
        go *somewhere*; the retry/rescore ladder covers a bad pick)."""
        now = time.monotonic()
        with self._lock:
            order = [(i + k) % self.n_shards
                     for k in range(self.n_shards)]
            usable = [d for d in order if d not in exclude]
            closed = [d for d in usable
                      if self._state[d]["fails"] < self.quarantine_after]
            if closed:
                return closed[0]
            half_open = [d for d in usable
                         if self._state[d]["open_until"] <= now]
            if half_open:
                dev = half_open[0]
                self._counters["device_probes"] += 1
                self.events.append(("probe", dev))
                return dev
            return usable[0] if usable else order[0]

    # -- executor management ------------------------------------------------
    def _executor(self) -> ThreadPoolExecutor:
        """The live executor — replaced (old one leaked deliberately to
        its wedged threads) once abandoned parts hold every worker."""
        with self._lock:
            if self._lost >= self._workers:
                self._pool.shutdown(wait=False)
                self._pool = ThreadPoolExecutor(
                    max_workers=self._workers,
                    thread_name_prefix="scoring-shard")
                self._lost = 0
                self._epoch += 1
            return self._pool

    def _abandon(self, futures: List) -> None:
        """Cancel what still can be; account for in-flight parts that
        cannot (they keep a device and an executor thread busy invisibly
        — the counter is the visibility) and swallow their results."""
        for f in futures:
            if f.cancel():
                continue
            if f.done():
                _swallow(f)
                continue
            with self._lock:
                self._counters["abandoned_parts"] += 1
                self._lost += 1
                epoch = self._epoch

            def _done(fut, _epoch=epoch):
                with self._lock:
                    if self._epoch == _epoch and self._lost > 0:
                        self._lost -= 1
                _swallow(fut)
            f.add_done_callback(_done)

    # -- dispatch and healing -----------------------------------------------
    def partitions(self, cells: int) -> int:
        """How many partitions a product of ``cells`` would occupy."""
        if self.n_shards == 1 or cells <= 0:
            return 1
        return max(min(self.n_shards,
                       cells // self.min_cells_per_shard), 1)

    def _timeout_for(self, deadline: Optional[float]) -> float:
        """One part-wait's budget: the window deadline's remaining time
        (floored so a just-expired deadline still lets an already-done
        future deliver), bounded by ``part_timeout_s`` either way."""
        if deadline is None:
            return self.part_timeout_s
        return max(min(self.part_timeout_s,
                       deadline - time.monotonic()), 0.01)

    def _score_on(self, part, hw: HardwareProfile, engine: str, dev: int):
        """``part``'s totals on slot ``dev``: its device, and on the card
        its own stream (the totals are read back before this returns, so
        nothing of the launch is left in flight)."""
        device, stream = self.devices[dev], self._streams[dev]
        if stream is None:
            return part.score(hw, engine=engine, shard=False, device=device)
        with torch.cuda.stream(stream):
            return part.score(hw, engine=engine, shard=False, device=device)

    def _submit(self, part, hw: HardwareProfile, engine: str, dev: int):
        def _run():
            faults.check("shards.dispatch", dev)
            return self._score_on(part, hw, engine, dev)
        return self._executor().submit(_run)

    def _await(self, future, deadline: Optional[float]):
        """``("ok", totals)`` / ``("timeout", seconds)`` /
        ``("nonfinite", None)`` / ``("error", exception)``."""
        timeout = self._timeout_for(deadline)
        try:
            value = future.result(timeout=timeout)
        except FutureTimeout:
            return "timeout", timeout
        except Exception as exc:
            return "error", exc
        if not np.isfinite(value).all():
            return "nonfinite", None
        return "ok", value

    def _note_failure(self, status, detail, dev: int, future,
                      abandon: bool = True) -> None:
        self._device_fail(dev)
        if status == "timeout":
            self._count("shard_timeouts")
            if abandon:
                self._abandon([future])
        elif status == "nonfinite":
            self._count("shard_nonfinite")

    def _hedge(self, idx: int, part, hw: HardwareProfile, engine: str,
               dev: int, original, deadline: Optional[float]):
        """Race a timed-out part against a hedged duplicate on another
        device; the first acceptable result wins and the straggler is
        abandoned.  A *spurious* timeout — the original was merely slow
        under scheduling noise or CPU contention, not hung — then costs
        the wait already paid plus epsilon, instead of a full serially
        awaited recompute (which on a small host cascades: the abandoned
        part still burns the core its duplicate needs)."""
        retry_dev = self._pick_device(idx + 1, exclude=(dev,)) \
            if self.n_shards > 1 else dev
        self._count("shard_retries")
        with self._lock:
            self.events.append(("retry", idx, dev, retry_dev))
        pending = {original: dev,
                   self._submit(part, hw, engine, retry_dev): retry_dev}
        # the race gets twice the per-part budget (deadline-capped): the
        # duplicate needs room for its own compute under contention —
        # a too-tight window here turns every hedge into a flat rescore
        # on top of two abandoned still-running computes
        budget = 2 * self.part_timeout_s
        if deadline is not None:
            budget = max(min(budget, deadline - time.monotonic()), 0.01)
        end = time.monotonic() + budget
        while pending:
            done, _ = futures_wait(list(pending),
                                   timeout=max(end - time.monotonic(), 0.0),
                                   return_when=FIRST_COMPLETED)
            if not done:
                self._count("shard_timeouts")
                break
            for f in done:
                d = pending.pop(f)
                try:
                    value = f.result()
                except Exception:
                    self._device_fail(d)
                    continue
                if not np.isfinite(value).all():
                    self._count("shard_nonfinite")
                    self._device_fail(d)
                    continue
                self._device_ok(d)
                self._abandon(list(pending))
                return value
            if set(pending) == {original}:
                # the duplicate died and only the original — which
                # already blew its timeout once — is left: bail to the
                # flat rescore now instead of sleeping out the rest of
                # the hedge budget on a part that is likely hung
                break
        for d in pending.values():
            self._device_fail(d)
        self._abandon(list(pending))
        return None

    def _heal_part(self, idx: int, part, hw: HardwareProfile, engine: str,
                   dev: int, future, deadline: Optional[float]):
        """Await one part; a timed-out part races a hedged duplicate on
        another device (first acceptable result back wins), other
        failures get one bounded retry on a different device, and both
        ladders fall back to a flat in-thread rescore of just this part."""
        status, detail = self._await(future, deadline)
        if status == "ok":
            self._device_ok(dev)
            return detail
        hedging = status == "timeout" and self.retries > 0
        self._note_failure(status, detail, dev, future,
                           abandon=not hedging)
        last_error = detail if status == "error" else None
        if hedging:
            value = self._hedge(idx, part, hw, engine, dev, future,
                                deadline)
            if value is not None:
                return value
        else:
            for _ in range(self.retries):
                retry_dev = self._pick_device(idx + 1, exclude=(dev,)) \
                    if self.n_shards > 1 else dev
                self._count("shard_retries")
                with self._lock:
                    self.events.append(("retry", idx, dev, retry_dev))
                future = self._submit(part, hw, engine, retry_dev)
                status, detail = self._await(future, deadline)
                if status == "ok":
                    self._device_ok(retry_dev)
                    return detail
                self._note_failure(status, detail, retry_dev, future)
                if status == "error":
                    last_error = detail
                dev = retry_dev
        # last resort: rescore ONLY this part, flat, in the worker thread,
        # on the first slot's device and this thread's own stream
        self._count("shard_rescored")
        try:
            value = part.score(hw, engine=engine, shard=False,
                               device=self.devices[0])
        except Exception:
            if last_error is not None:
                raise last_error
            if status == "timeout":
                raise ShardTimeout(
                    f"part {idx} timed out on-device and failed its flat "
                    f"rescore", part=idx, timeout_s=detail) from None
            raise
        if not np.isfinite(value).all():
            self._count("shard_nonfinite")
            raise NonFiniteScore(
                f"part {idx} totals non-finite after retry and flat "
                f"rescore (corrupt parameter banks?)")
        return value

    def _score_parts(self, parts: List, hw: HardwareProfile, engine: str,
                     before_dispatch: Optional[Callable[[int], bool]],
                     deadline: Optional[float]) -> Optional[List]:
        if len(parts) == 1 and deadline is None \
                and faults.active() is None:
            # steady-state single-part fast path: in-thread, no executor
            # hop — byte-for-byte the pre-shard service behavior
            if before_dispatch is not None and not before_dispatch(0):
                return None
            value = parts[0].score(hw, engine=engine, shard=False,
                                   device=self.devices[0])
            if not np.isfinite(value).all():
                self._count("shard_nonfinite")
                raise NonFiniteScore(
                    "totals non-finite (corrupt parameter banks?)")
            return [value]
        entries = []
        for i, part in enumerate(parts):
            if before_dispatch is not None and not before_dispatch(i):
                self._abandon([f for _, f in entries])
                return None
            dev = self._pick_device(i)
            entries.append((dev, self._submit(part, hw, engine, dev)))
        return [self._heal_part(i, parts[i], hw, engine, dev, fut,
                                deadline)
                for i, (dev, fut) in enumerate(entries)]

    # -- the scoring entry points -------------------------------------------
    def score_frontier(self, packed: PackedFrontier, hw: HardwareProfile,
                       engine: str = "fused",
                       before_dispatch: Optional[Callable[[int], bool]]
                       = None, deadline: Optional[float] = None
                       ) -> Tuple[Optional[np.ndarray], int]:
        """``(per-design totals, shards used)`` for a spliced frontier.

        Totals are ``None`` only when ``before_dispatch`` aborted the
        group (every owner already expired).  ``deadline`` is the
        window's absolute ``time.monotonic()`` deadline: every part-wait
        is bounded by its remaining time (and by ``part_timeout_s``
        regardless), raising :class:`ShardTimeout` instead of blocking
        the worker loop forever behind a hung device call."""
        n = self.partitions(packed.n_segments) if engine == "fused" else 1
        parts = packed.split(n)
        results = self._score_parts(list(parts), hw, engine,
                                    before_dispatch, deadline)
        if results is None:
            return None, 0
        if len(results) == 1:
            return results[0], 1
        return np.concatenate(results), len(parts)

    def score_sweep(self, sweep: PackedSweep, hw: HardwareProfile,
                    engine: str = "fused",
                    before_dispatch: Optional[Callable[[int], bool]]
                    = None, deadline: Optional[float] = None
                    ) -> Tuple[Optional[np.ndarray], int]:
        """``([points, designs] grid, shards used)`` for a spliced sweep.

        Partitions cut the design axis (every coalesced sweep in the
        group shares the point axis); the merged grid stacks partition
        columns back in order.  ``deadline`` bounds part-waits exactly
        as in :meth:`score_frontier`."""
        n = self.partitions(sweep.n_points * sweep.n_designs) \
            if engine == "fused" else 1
        parts = sweep.split(min(n, max(sweep.n_designs, 1)))
        results = self._score_parts(list(parts), hw, engine,
                                    before_dispatch, deadline)
        if results is None:
            return None, 0
        if len(results) == 1:
            return results[0], 1
        return np.concatenate(results, axis=1), len(parts)

    def close(self) -> None:
        with self._lock:
            pool = self._pool
        if pool is not None:
            pool.shutdown(wait=False)
