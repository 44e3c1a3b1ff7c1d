"""Priority lanes: bounded per-lane queues with weighted dequeue.

The port's twin of the reference's ``serving/lanes.py``, verbatim: pure
Python, no device code.

The coalescing worker used to drain one unbounded FIFO — so a burst of
bulk sweeps ahead of an interactive what-if delayed it by the whole
burst's scoring time.  :class:`LaneScheduler` replaces that queue:

* **Two lanes** — :data:`INTERACTIVE` (what-if questions, small
  auto-completions) and :data:`BULK` (sweeps, large completions) — each
  a bounded FIFO.  ``put`` on a full lane raises
  :class:`~repro_torch.serving.admission.RejectedError` immediately: shed on
  overload, never an unbounded backlog, never a blocked producer.
* **Weighted dequeue** — ``get`` serves lanes by weighted round-robin
  (default 4 interactive : 1 bulk).  While both lanes hold work, at
  most ``1/(w_i+w_b)`` of a coalescing window is bulk; when the
  interactive lane is empty, bulk flows at full rate.  An interactive
  arrival therefore waits on at most the *currently scoring* call, not
  on the bulk backlog.
* **Shutdown** — ``close()`` stops admission (``put`` raises
  :class:`~repro_torch.serving.admission.ServiceStoppedError` carrying the
  lane depth as the would-be queue position) while ``get`` keeps
  draining; once both lanes are empty a closed scheduler hands back
  :data:`CLOSED`.  ``drain()`` empties what is left (used to fail
  stragglers when the worker is already gone), reporting each item's
  queue position.

Single condition variable, no per-lane threads; the worker's coalescing
window logic is unchanged — it just asks the scheduler instead of a
``queue.Queue``.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.admission import RejectedError, ServiceStoppedError

#: the latency-sensitive lane: what-if questions, small completions
INTERACTIVE = "interactive"
#: the throughput lane: workload sweeps, large completions
BULK = "bulk"
#: lanes in priority order (ties in the weighted round go left-first)
LANES: Tuple[str, ...] = (INTERACTIVE, BULK)

#: returned by :meth:`LaneScheduler.get` once closed and fully drained
CLOSED = object()


class LaneScheduler:
    """Bounded multi-lane queue with weighted round-robin dequeue."""

    def __init__(self, capacities: Optional[Dict[str, int]] = None,
                 weights: Optional[Dict[str, int]] = None,
                 lanes: Sequence[str] = LANES) -> None:
        self.lanes = tuple(lanes)
        self.capacities = {lane: int((capacities or {}).get(lane, 1024))
                           for lane in self.lanes}
        self.weights = {lane: max(int((weights or {}).get(lane, 1)), 1)
                        for lane in self.lanes}
        self._queues: Dict[str, collections.deque] = {
            lane: collections.deque() for lane in self.lanes}
        self._credits = dict(self.weights)
        self._cond = threading.Condition()
        self._closed = False

    # -- producers -----------------------------------------------------------
    def put(self, item, lane: str = INTERACTIVE) -> int:
        """Enqueue on ``lane``; returns the queue position (0 = head).

        Raises :class:`RejectedError` when the lane is at capacity and
        :class:`ServiceStoppedError` after :meth:`close`."""
        if lane not in self._queues:
            raise KeyError(f"unknown lane: {lane!r}")
        with self._cond:
            q = self._queues[lane]
            if self._closed:
                raise ServiceStoppedError(
                    f"service stopped; not accepting {lane} requests",
                    queue_position=len(q))
            cap = self.capacities[lane]
            if len(q) >= cap:
                raise RejectedError(
                    f"{lane} lane full ({len(q)}/{cap}); request shed",
                    lane=lane, depth=len(q), limit=cap)
            q.append(item)
            self._cond.notify()
            return len(q) - 1

    # -- the worker ----------------------------------------------------------
    def _pick(self, allowed: Optional[Sequence[str]] = None) -> Optional[str]:
        """The next lane to serve, by weighted round-robin with priority
        tie-break (must hold the condition)."""
        ready = [lane for lane in (allowed or self.lanes)
                 if self._queues[lane]]
        if not ready:
            return None
        with_credit = [lane for lane in ready if self._credits[lane] > 0]
        if not with_credit:
            # everyone ready spent their round: start a fresh one
            self._credits = dict(self.weights)
            with_credit = ready
        return with_credit[0]

    def get(self, timeout: Optional[float] = None,
            lanes: Optional[Sequence[str]] = None):
        """The next item by lane weight; ``None`` on timeout;
        :data:`CLOSED` once closed and drained.

        ``lanes`` restricts the pick to a subset — the worker uses it to
        cap how much bulk a single coalescing window may absorb while
        still accepting interactive arrivals until the window closes."""
        with self._cond:
            while True:
                lane = self._pick(lanes)
                if lane is not None:
                    self._credits[lane] -= 1
                    return self._queues[lane].popleft()
                if self._closed:
                    # an unrestricted pick that found nothing means fully
                    # drained; a restricted one must NOT report CLOSED
                    # while other lanes still hold work to drain
                    if lanes is None or not any(
                            len(q) for q in self._queues.values()):
                        return CLOSED
                    return None
                if not self._cond.wait(timeout):
                    return None

    # -- lifecycle / introspection -------------------------------------------
    def close(self) -> None:
        """Stop admission; the worker drains what is queued, then sees
        :data:`CLOSED`."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reopen(self) -> None:
        """Accept traffic again (a restarted service reuses its scheduler)."""
        with self._cond:
            self._closed = False
            self._credits = dict(self.weights)

    def drain(self) -> List[Tuple[object, str, int]]:
        """Empty every lane: ``(item, lane, queue_position)`` per item."""
        with self._cond:
            out: List[Tuple[object, str, int]] = []
            for lane in self.lanes:
                q = self._queues[lane]
                pos = 0
                while q:
                    out.append((q.popleft(), lane, pos))
                    pos += 1
            return out

    def depth(self, lane: Optional[str] = None) -> int:
        with self._cond:
            if lane is not None:
                return len(self._queues[lane])
            return sum(len(q) for q in self._queues.values())
