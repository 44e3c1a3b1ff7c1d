"""Admission control for the serving tier: errors, cost pricing, budgets.

The port's twin of the reference's ``serving/admission.py``, verbatim: pure
Python, no device code.

The Data Calculator's serving promise is *interactive* answers, and the
service coalesces aggressively — but coalescing without backpressure
means one bulk ``submit_sweep`` flood can absorb every worker cycle
while interactive what-ifs rot in the queue.  This module is the
admission edge in front of the coalescing worker:

* **Typed rejections.**  Every way a request can fail *without being
  served* gets its own exception so load-test clients (and real ones)
  can tell the regimes apart: :class:`RejectedError` (bounded queue
  full — shed on overload), :class:`BudgetExceeded` (the session's
  token bucket is dry — a :class:`RejectedError` subclass, so "shed"
  handlers catch both), :class:`DeadlineExceeded` (admitted, but the
  deadline passed before/while serving), and
  :class:`ServiceStoppedError` (shutdown raced the request — carries
  the queue position so clients can distinguish shutdown from
  overload).
* **Cost pricing.**  A request is priced in *cells* — estimated
  designs x workload-points scored (:func:`request_cost`) — so a
  640-design x 8-workload sweep pays 5120x what a single what-if pays,
  proportionally to the scoring work it will occupy.
* **Per-session token buckets.**  :class:`SessionBudgets` hands each
  session a :class:`TokenBucket` (capacity + refill rate in
  cells/second).  A request whose cost cannot be acquired is rejected
  *at submit time* — before it holds a queue slot.

Semantics are documented in ``docs/serving.md``; exercised by
``tests/test_torch_admission.py``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class ServiceError(RuntimeError):
    """Base class for serving-tier request failures."""


class RejectedError(ServiceError):
    """Shed on overload: a bounded lane queue (or budget) refused the
    request.  The request was never queued — retry later or back off."""

    def __init__(self, message: str, *, lane: Optional[str] = None,
                 depth: Optional[int] = None,
                 limit: Optional[int] = None) -> None:
        super().__init__(message)
        self.lane = lane
        self.depth = depth      # queue depth observed at rejection
        self.limit = limit      # the lane's configured bound


class BudgetExceeded(RejectedError):
    """The session's token-bucket cost budget cannot cover the request."""

    def __init__(self, message: str, *, session: str, cost: float,
                 available: float) -> None:
        super().__init__(message)
        self.session = session
        self.cost = cost
        self.available = available


class DeadlineExceeded(ServiceError):
    """The request's deadline passed before it could be (fully) served."""

    def __init__(self, message: str, *, deadline_s: float,
                 late_by_s: float) -> None:
        super().__init__(message)
        self.deadline_s = deadline_s    # the relative deadline requested
        self.late_by_s = late_by_s      # how far past it we noticed


class WorkerCrashed(ServiceError):
    """The serving worker died while this request was in flight.

    The supervisor restarts the worker (bounded restarts with backoff —
    see ``docs/serving.md``), but the crashed window's requests are NOT
    replayed: the client gets this typed error immediately and may
    resubmit.  ``cause`` carries the exception that killed the worker;
    ``restarts`` is the worker's restart count at failure time."""

    def __init__(self, message: str, *,
                 cause: Optional[BaseException] = None,
                 restarts: int = 0) -> None:
        super().__init__(message)
        self.cause = cause
        self.restarts = restarts


class ServiceStoppedError(ServiceError):
    """The service stopped before serving this request.

    ``queue_position`` is where the request sat when shutdown caught it
    (0 = head of its lane), so clients can tell an orderly shutdown from
    an overload shed (:class:`RejectedError`)."""

    def __init__(self, message: str,
                 queue_position: Optional[int] = None) -> None:
        super().__init__(message)
        self.queue_position = queue_position


def request_cost(n_designs: int, n_points: int = 1) -> float:
    """Price a request in *cells*: designs x workload points scored.

    This is the unit the fused scorer's work actually scales with — a
    flat what-if is ~2 cells, an auto-completion pays its frontier size,
    a sweep pays its whole grid."""
    return float(max(n_designs, 1) * max(n_points, 1))


class TokenBucket:
    """A classic token bucket in *cells* (thread-safe).

    ``capacity`` bounds the burst a session can land at once;
    ``refill_per_s`` is the sustained cells/second it may consume.
    ``try_acquire`` never blocks — admission control sheds, it does not
    queue debtors."""

    def __init__(self, capacity: float, refill_per_s: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if capacity <= 0 or refill_per_s <= 0:
            raise ValueError("capacity and refill_per_s must be positive")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._tokens = float(capacity)
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        elapsed = max(now - self._stamp, 0.0)
        self._stamp = now
        self._tokens = min(self.capacity,
                           self._tokens + elapsed * self.refill_per_s)

    def available(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens

    def try_acquire(self, cost: float) -> bool:
        with self._lock:
            self._refill(self._clock())
            if cost > self._tokens:
                return False
            self._tokens -= cost
            return True


class SessionBudgets:
    """Per-session :class:`TokenBucket`s, created on first use.

    Sessionless requests share the ``"_anonymous"`` bucket, so an
    unidentified flood still cannot starve identified sessions."""

    ANONYMOUS = "_anonymous"

    def __init__(self, capacity: float, refill_per_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.capacity = float(capacity)
        #: default sustained rate: one full budget per second
        self.refill_per_s = float(refill_per_s if refill_per_s is not None
                                  else capacity)
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def bucket(self, session: Optional[str]) -> TokenBucket:
        name = session or self.ANONYMOUS
        with self._lock:
            bucket = self._buckets.get(name)
            if bucket is None:
                bucket = TokenBucket(self.capacity, self.refill_per_s,
                                     clock=self._clock)
                self._buckets[name] = bucket
        return bucket

    def admit(self, session: Optional[str], cost: float) -> None:
        """Charge ``cost`` to the session or raise :class:`BudgetExceeded`."""
        bucket = self.bucket(session)
        if not bucket.try_acquire(cost):
            name = session or self.ANONYMOUS
            raise BudgetExceeded(
                f"session {name!r} budget exhausted: request costs "
                f"{cost:.0f} cells, {bucket.available():.0f} available "
                f"(capacity {bucket.capacity:.0f}, refill "
                f"{bucket.refill_per_s:.0f}/s)",
                session=name, cost=cost, available=bucket.available())
