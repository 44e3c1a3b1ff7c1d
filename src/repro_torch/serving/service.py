"""Micro-batching what-if serving engine on the card.

The port's twin of the reference's ``serving/service.py``.  The paper's
headline promise is *interactive* design questions, and a design session
is long runs of many small, related questions against a shared design
continuum.  Served naively, every question pays a full K0 launch, and
concurrent designers hammer the module-level synthesis memos from many
threads.

:class:`DesignCalculatorService` is the long-lived serving loop those
sessions talk to:

* **Resident state.**  Registered :class:`~repro_torch.core.hardware.
  HardwareProfile`s keep their device parameter banks built on every
  scoring slot's device (:func:`repro_torch.core.devicecost.
  device_table`), so no question ever pays bank construction; the
  packed-frontier/segment caches of :mod:`repro_torch.core.batchcost`
  (thread-safe via :mod:`repro_torch.core.memo`) persist across
  questions.
* **Micro-batching.**  Requests are submitted from any thread and return
  :class:`concurrent.futures.Future`s.  A single worker drains the
  lanes: the first request opens a coalescing window (``window_s``),
  everything arriving inside it joins the batch, and the batch is served
  by splicing every question's packed frontier into **one**
  :func:`~repro_torch.core.batchcost.concat_frontiers` frontier per
  distinct hardware profile — one fused scoring call each.  A
  hardware-variant question contributes the *same* packed frontier to
  two profile groups: a pure parameter-table swap, no new kernel
  specialisation.
* **Admission control and priority lanes.**  Requests are priced in
  cells (:func:`repro_torch.serving.admission.request_cost` — estimated
  designs x workload points) and admitted through bounded per-lane
  queues (:class:`repro_torch.serving.lanes.LaneScheduler`): interactive
  what-ifs in one lane, bulk sweeps / large completions in the other,
  dequeued by weighted round-robin.  A full lane sheds with
  :class:`~repro_torch.serving.admission.RejectedError`; optional
  per-session token buckets (``budget_cells``) shed with
  :class:`~repro_torch.serving.admission.BudgetExceeded` before a
  request holds a queue slot.  Within a batch, interactive groups score
  *first* and their futures resolve eagerly.
* **Deadlines and cancellation.**  A per-request deadline
  (``deadline_s``) is checked when the batch is assembled and again
  between coalesced scoring calls; an expired request fails fast with
  :class:`~repro_torch.serving.admission.DeadlineExceeded`.
  ``Future.cancel()`` before the worker picks a request up drops it
  without scoring.
* **Warm restart.**  ``snapshot_path`` makes ``start()`` restore the
  template-statics and packed-segment memos from a versioned on-disk
  snapshot (:func:`repro_torch.core.memo.restore_caches_report`;
  :meth:`DesignCalculatorService.save_snapshot` writes one, with every
  per-device layout stripped) — a corrupt or stale snapshot
  cold-starts, never crashes.
* **Per-session frontier reuse.**  A :class:`ServiceSession` pins the
  packed frontiers of its recent questions.
* **Workload sweeps and searches.**  ``submit_sweep`` serves whole
  (designs x workloads) grids; sweeps in one window sharing a
  workload-point axis splice along the design axis and score as ONE
  fused sweep call per profile.  ``submit_search`` runs
  :func:`repro_torch.core.search.population_search` with every
  generation scored through ``submit_sweep``.
* **Routing and healing.**  The scoring-shard pool
  (:class:`repro_torch.serving.shards.ScoringShardPool`, over the slots
  ``scoring_devices``) splits a group across slots; a fused failure
  falls back fused -> fused-flat, then, on the CPU only, to the grouped
  oracle, and every answer carries the ``engine`` that produced it.  On
  the card the grouped oracle (host numpy) never answers: a group that
  fails both fused calls fails its futures, and the recovery probe
  rebuilds the profile's banks.

Answers are exactly :class:`~repro_torch.core.whatif.WhatIfAnswer` /
:class:`~repro_torch.core.whatif.WorkloadSweepAnswer` /
:class:`~repro_torch.core.autocomplete.SearchResult`; parity with the
reference's service and the scalar oracle is asserted in
``tests/test_torch_serving.py``, the traffic behaviour in
``tests/test_torch_admission.py``.  Semantics follow the reference's
``docs/serving.md``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import devicecost, memo
from repro_torch.core.autocomplete import SearchResult, enumerate_frontier
from repro_torch.core.batchcost import (PackedFrontier, concat_frontiers,
                                        concat_sweeps,
                                        normalize_points, pack_frontier,
                                        pack_sweep)
from repro_torch.core.elements import DataStructureSpec, Element
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.synthesis import Workload
from repro_torch.core.whatif import (WhatIfAnswer, WorkloadSweepAnswer,
                                     question_design, question_hardware,
                                     question_sweep, question_workload)
from repro_torch.serving.admission import (BudgetExceeded,
                                           DeadlineExceeded, RejectedError,
                                           ServiceError, ServiceStoppedError,
                                           SessionBudgets, WorkerCrashed,
                                           request_cost)
from repro_torch.serving.lanes import (BULK, CLOSED, INTERACTIVE,
                                       LaneScheduler)
from repro_torch.serving.shards import NonFiniteScore, ScoringShardPool
from repro_torch.testing import faults

_LOG = logging.getLogger("repro_torch.serving")


class FusedEngineDown(ServiceError):
    """A question about a profile whose fused engine failed on the card:
    it is refused until the recovery probe has rebuilt the profile's
    banks (the grouped oracle, host numpy, answers only on the CPU)."""


@dataclasses.dataclass
class ServiceStats:
    """Serving counters (snapshot with
    :meth:`DesignCalculatorService.stats`)."""

    questions: int = 0          # requests submitted (admitted or not)
    answered: int = 0           # futures resolved successfully
    failed: int = 0             # futures resolved with an exception
    batches: int = 0            # non-empty coalescing windows served
    empty_windows: int = 0      # windows that closed with no requests
    coalesced: int = 0          # requests that shared a batch with others
    score_calls: int = 0        # fused/grouped scoring calls issued
    max_batch: int = 0          # largest batch served
    session_frontier_hits: int = 0
    sweeps: int = 0             # workload-sweep requests submitted
    searches: int = 0           # population-search requests submitted
    shed_interactive: int = 0   # interactive-lane overload rejections
    shed_bulk: int = 0          # bulk-lane overload rejections
    budget_rejected: int = 0    # session token-bucket rejections
    expired: int = 0            # requests failed with DeadlineExceeded
    cancelled: int = 0          # futures cancelled before serving
    stopped_requests: int = 0   # requests failed by shutdown
    snapshot_entries: int = 0   # cache entries restored on start()
    shard_dispatches: int = 0   # partitions dispatched by multi-shard groups
    # -- fault tolerance (the shard pool's own retry/quarantine counters
    # merge into stats() from ScoringShardPool.stats()) ------------------
    nonfinite_groups: int = 0   # merged group totals that failed isfinite
    fallback_flat: int = 0      # groups served by the flat fused fallback
    fallback_grouped: int = 0   # groups served by the grouped oracle
    engine_degraded: int = 0    # profiles demoted off the fused engine
    engine_recovered: int = 0   # profiles recovered by a fused probe
    worker_restarts: int = 0    # supervisor resurrections of the worker
    snapshot_restored: int = 0  # warm restarts that loaded entries
    snapshot_discarded: int = 0  # snapshots discarded (corrupt/stale/error)
    snapshot_corrupt: int = 0   # the unreadable subset of discarded


@dataclasses.dataclass
class _Evaluation:
    """One frontier-under-one-profile scoring unit of a request.

    Requests decompose into evaluations; the batcher groups evaluations
    by (hardware profile, sweep points) and scores each group in one
    fused call.  After scoring, ``totals`` holds this evaluation's
    per-design slice (flat questions) or its ``[points, designs]`` grid
    columns (sweeps, where ``points`` is set and ``workload``/``mix``
    are unused).
    """

    specs: Tuple[DataStructureSpec, ...]
    workload: Optional[Workload]
    mix: Optional[Dict[str, float]]
    hw_name: str
    session: Optional[str] = None
    points: Optional[Tuple] = None      # sweep evaluations only
    packed: Optional[PackedFrontier] = None   # PackedSweep for sweeps
    totals: Optional[np.ndarray] = None
    error: Optional[Exception] = None   # this evaluation's scoring failure
    owner: Optional["_Request"] = None  # back-pointer, set at serve time
    engine: Optional[str] = None        # which engine produced totals


@dataclasses.dataclass
class _Request:
    evals: List[_Evaluation]
    finalize: Callable[[float], object]   # elapsed-seconds -> answer
    future: Future
    t0: float
    lane: str = INTERACTIVE
    deadline: Optional[float] = None      # absolute time.monotonic()
    deadline_s: Optional[float] = None    # the relative deadline requested
    cost: float = 1.0                     # admission price in cells
    remaining: int = 0                    # evals not yet scored/errored
    dead: bool = False                    # expired/cancelled mid-batch


class _SessionState:
    """Packed frontiers pinned by one session.

    Reads/writes go through an internal lock: the worker thread owns the
    steady-state traffic, but warm-restart plumbing and tests touch pins
    from other threads, and an unguarded ``OrderedDict``
    ``get``+``move_to_end`` is exactly the torn-bookkeeping pattern
    ``repro_torch.core.memo`` exists to prevent."""

    def __init__(self, maxsize: int = 64) -> None:
        self.frontiers: "collections.OrderedDict" = collections.OrderedDict()
        self.maxsize = maxsize
        self._lock = threading.RLock()

    def get(self, key) -> Optional[PackedFrontier]:
        with self._lock:
            packed = self.frontiers.get(key)
            if packed is not None:
                self.frontiers.move_to_end(key)
            return packed

    def put(self, key, packed: PackedFrontier) -> None:
        with self._lock:
            self.frontiers[key] = packed
            if len(self.frontiers) > self.maxsize:
                self.frontiers.popitem(last=False)


@dataclasses.dataclass
class ServiceSession:
    """A designer's handle on the service: same questions, pinned frontiers."""

    service: "DesignCalculatorService"
    name: str

    def what_if_design(self, spec, variant, workload, hw, mix=None,
                       **kwargs):
        return self.service.what_if_design(spec, variant, workload, hw, mix,
                                           session=self.name, **kwargs)

    def what_if_hardware(self, spec, workload, hw, new_hw, mix=None,
                         **kwargs):
        return self.service.what_if_hardware(spec, workload, hw, new_hw, mix,
                                             session=self.name, **kwargs)

    def what_if_workload(self, spec, workload, new_workload, hw, mix=None,
                         **kwargs):
        return self.service.what_if_workload(spec, workload, new_workload,
                                             hw, mix, session=self.name,
                                             **kwargs)

    def complete_design(self, partial, workload, hw, **kwargs):
        return self.service.complete_design(partial, workload, hw,
                                            session=self.name, **kwargs)

    def workload_sweep(self, specs, workloads, hw, mixes=None, **kwargs):
        return self.service.workload_sweep(specs, workloads, hw, mixes,
                                           session=self.name, **kwargs)


class DesignCalculatorService:
    """Long-lived concurrent what-if server (see module docstring).

    Parameters
    ----------
    profiles:
        Hardware profiles to register up front (device banks are built
        immediately; more can be registered later, or implicitly by
        asking a question about an unregistered profile object).
    window_s:
        The coalescing window: how long the worker keeps a batch open
        after its first request arrives.
    max_batch:
        Hard cap on requests per batch (the window closes early).
    engine:
        ``"fused"`` (default) or ``"grouped"`` — every scoring call goes
        through :meth:`PackedFrontier.score` with this engine.
    lanes:
        ``True`` (default) runs the two-lane weighted scheduler with
        interactive-first group scoring.  ``False`` is the pre-hardening
        FIFO regime — one queue, no priority, futures resolve when the
        whole batch has scored — kept as the load-benchmark baseline.
    interactive_capacity / bulk_capacity:
        Bounded lane depths; a full lane sheds new requests with
        :class:`~repro_torch.serving.admission.RejectedError`.
    lane_weights:
        Dequeues per lane per weighted round (default 4 interactive :
        1 bulk).
    bulk_threshold:
        Auto-completions whose enumerated frontier reaches this many
        designs ride the bulk lane (sweeps always do).
    bulk_per_window:
        When set, at most this many bulk requests join one coalescing
        window (excess bulk stays queued for later windows, and the
        window keeps accepting interactive arrivals until it closes) —
        the strict per-window occupancy bound for latency-critical
        deployments.  ``None`` (default) lets same-axis bulk work
        coalesce freely.
    budget_cells / budget_refill_per_s:
        When ``budget_cells`` is set, each session gets a token bucket
        of that capacity (refilling at ``budget_refill_per_s`` cells/s,
        default one capacity per second); requests are priced via
        :func:`repro_torch.serving.admission.request_cost` and shed with
        :class:`~repro_torch.serving.admission.BudgetExceeded` when the
        bucket is dry.
    default_deadline_s:
        Deadline applied to requests that do not pass their own.
    snapshot_path:
        When set, ``start()`` warm-restores the template-statics and
        packed-segment memos from this snapshot (if present and
        version-compatible) and :meth:`save_snapshot` writes it.
    scoring_devices / scoring_shards / shard_min_cells:
        The scoring-shard pool (:class:`repro_torch.serving.shards.
        ScoringShardPool`): ``scoring_devices`` are its slots' devices
        (a device may repeat), ``scoring_shards`` caps the slots.  With
        neither, the pool has one slot on the runtime device: no run on
        several cards has measured the split yet, so more slots are
        taken only when asked for (``scoring_shards`` alone takes up to
        that many of :func:`repro_torch.core.devicecost.shard_devices`).  Each
        (profile, axis) group's spliced product partitions across the
        slots once it spans ``shard_min_cells`` cells per partition,
        dispatches concurrently with deadlines probed between shard
        dispatches, and merges bit-identically before any future
        resolves.  With one slot the pool degenerates to an in-thread
        call.
    """

    def __init__(self, profiles: Sequence[HardwareProfile] = (), *,
                 window_s: float = 0.002, max_batch: int = 1024,
                 engine: str = "fused", start: bool = True,
                 lanes: bool = True,
                 interactive_capacity: int = 4096,
                 bulk_capacity: int = 256,
                 lane_weights: Optional[Dict[str, int]] = None,
                 bulk_threshold: int = 64,
                 bulk_per_window: Optional[int] = None,
                 budget_cells: Optional[float] = None,
                 budget_refill_per_s: Optional[float] = None,
                 default_deadline_s: Optional[float] = None,
                 snapshot_path: Optional[str] = None,
                 scoring_shards: Optional[int] = None,
                 scoring_devices: Optional[Sequence] = None,
                 shard_min_cells: Optional[int] = None,
                 shard_part_timeout_s: Optional[float] = None,
                 shard_retries: Optional[int] = None,
                 shard_quarantine_after: Optional[int] = None,
                 shard_quarantine_s: Optional[float] = None,
                 fused_failure_threshold: int = 2,
                 engine_probe_s: float = 2.0,
                 max_worker_restarts: int = 8,
                 worker_backoff_s: float = 0.02) -> None:
        if engine not in ("fused", "grouped"):
            raise ValueError(f"unknown serving engine: {engine!r}")
        self._engine = engine
        self._window = window_s
        self._max_batch = max_batch
        self._lanes_enabled = lanes
        self._bulk_threshold = bulk_threshold
        self._bulk_per_window = bulk_per_window if lanes else None
        self._default_deadline = default_deadline_s
        self._snapshot_path = snapshot_path
        self._restored = False
        if lanes:
            self._sched = LaneScheduler(
                capacities={INTERACTIVE: interactive_capacity,
                            BULK: bulk_capacity},
                weights=lane_weights or {INTERACTIVE: 4, BULK: 1})
        else:   # FIFO baseline: one lane sized like the two combined
            self._sched = LaneScheduler(
                capacities={INTERACTIVE: interactive_capacity
                            + bulk_capacity},
                weights={INTERACTIVE: 1}, lanes=(INTERACTIVE,))
        self._budgets = (SessionBudgets(budget_cells, budget_refill_per_s)
                         if budget_cells is not None else None)
        pool_kwargs = {}
        for name, value in (("min_cells_per_shard", shard_min_cells),
                            ("part_timeout_s", shard_part_timeout_s),
                            ("retries", shard_retries),
                            ("quarantine_after", shard_quarantine_after),
                            ("quarantine_s", shard_quarantine_s)):
            if value is not None:
                pool_kwargs[name] = value
        if scoring_shards is None and scoring_devices is None:
            scoring_shards = 1
        self._shards = ScoringShardPool(scoring_shards,
                                        devices=scoring_devices,
                                        **pool_kwargs)
        #: the grouped oracle is host numpy: it may answer for a failed
        #: fused engine only when the slots themselves are on the CPU
        self._oracle_fallback = all(d.type == "cpu"
                                    for d in self._shards.devices)
        self._fused_failure_threshold = max(int(fused_failure_threshold), 1)
        self._engine_probe_s = float(engine_probe_s)
        self._max_worker_restarts = max(int(max_worker_restarts), 0)
        self._worker_backoff_s = float(worker_backoff_s)
        #: per-profile fused-engine health (guarded by self._lock):
        #: name -> {"degraded": bool, "fails": int, "next_probe": float}
        self._engine_health: Dict[str, Dict] = {}
        self._snapshot_outcome = "disabled" if not snapshot_path \
            else "pending"
        self._inflight: List[_Request] = []
        self._profiles: Dict[str, HardwareProfile] = {}
        self._sessions: Dict[str, _SessionState] = {}
        self._session_counter = itertools.count()
        self._lock = threading.Lock()      # profiles/sessions/stats registry
        self._stats = ServiceStats()
        self._thread: Optional[threading.Thread] = None
        for hw in profiles:
            self.register_hardware(hw)
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        if self._snapshot_path and not self._restored:
            # warm restart: restore the statics/segment memos — never
            # raises, but the outcome (restored / missing / corrupt /
            # stale / error) is recorded, not swallowed
            report = memo.restore_caches_report(self._snapshot_path)
            self._restored = True
            self._snapshot_outcome = report.outcome
            with self._lock:
                self._stats.snapshot_entries = report.entries
                if report.outcome == "restored":
                    self._stats.snapshot_restored += 1
                elif report.outcome in ("corrupt", "stale", "error"):
                    self._stats.snapshot_discarded += 1
                    if report.outcome == "corrupt":
                        self._stats.snapshot_corrupt += 1
            if report.outcome in ("corrupt", "stale", "error"):
                _LOG.warning(
                    "discarded %s warm-restart snapshot at %s; "
                    "cold-starting", report.outcome, self._snapshot_path)
        self._sched.reopen()
        self._thread = threading.Thread(target=self._supervise, daemon=True,
                                        name="design-calculator-serving")
        self._thread.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain already-queued requests, then stop the worker.

        Admission closes immediately: a submit that races shutdown fails
        with :class:`~repro_torch.serving.admission.ServiceStoppedError`
        (carrying its would-be queue position) — distinguishable from an
        overload shed.  If ``timeout`` expires with the worker still
        running, the service stays stoppable/startable — the thread is
        only forgotten once dead."""
        if self._thread is None:
            return
        self._sched.close()
        self._thread.join(timeout)
        if self._thread.is_alive():    # timed out; try again later
            return
        self._thread = None
        self._fail_pending()

    def _fail_pending(self) -> None:
        """Fail every request still queued after the worker has exited."""
        for req, lane, pos in self._sched.drain():
            if req.future.done():
                continue
            self._count("failed")
            self._count("stopped_requests")
            req.future.set_exception(ServiceStoppedError(
                f"service stopped before serving this request "
                f"(position {pos} in the {lane} lane)",
                queue_position=pos))

    close = stop

    def __enter__(self) -> "DesignCalculatorService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def save_snapshot(self, path: Optional[str] = None) -> int:
        """Persist the warm-restart snapshot (template statics + packed
        segments + the model-id interning table) atomically; returns the
        number of entries written."""
        path = path or self._snapshot_path
        if not path:
            raise ValueError("no snapshot path configured")
        return memo.snapshot_caches(path)

    # -- registry -----------------------------------------------------------
    def register_hardware(self, hw: HardwareProfile) -> str:
        """Register a profile and build its device parameter banks now, on
        every scoring slot's device, so the first question about it pays
        no bank construction."""
        with self._lock:
            self._profiles[hw.name] = hw
        for dev in dict.fromkeys(self._shards.devices):
            devicecost.device_table(hw, dev)
        return hw.name

    def _profile_name(self, hw) -> str:
        if isinstance(hw, str):
            if hw not in self._profiles:
                raise KeyError(f"unregistered hardware profile: {hw!r}")
            return hw
        if self._profiles.get(hw.name) is not hw:
            self.register_hardware(hw)
        return hw.name

    def session(self, name: Optional[str] = None) -> ServiceSession:
        """Open (or re-attach to) a designer session with pinned frontiers."""
        name = name or f"session-{next(self._session_counter)}"
        with self._lock:
            self._sessions.setdefault(name, _SessionState())
        return ServiceSession(self, name)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(dataclasses.asdict(self._stats))
        out.update(self._shards.stats())
        for lane in self._sched.lanes:
            out[f"queued_{lane}"] = self._sched.depth(lane)
        return out

    def health(self) -> Dict:
        """One structured snapshot of the service's fault-tolerance
        state: worker liveness/restarts, per-profile engine health
        (degraded profiles serve from the grouped oracle on the CPU, and
        are refused on the card, until a fused probe succeeds), per-slot
        breaker state, queue depths and the
        warm-restart snapshot outcome."""
        thread = self._thread
        now = time.monotonic()
        with self._lock:
            engines = {
                name: {"engine": ("grouped" if self._oracle_fallback
                                  else "down") if st["degraded"]
                       else self._engine,
                       "degraded": st["degraded"],
                       "consecutive_failures": st["fails"],
                       "next_probe_in_s": max(st["next_probe"] - now, 0.0)
                       if st["degraded"] else 0.0}
                for name, st in self._engine_health.items()}
            restarts = self._stats.worker_restarts
            snapshot = {"outcome": self._snapshot_outcome,
                        "entries": self._stats.snapshot_entries}
        return {
            "worker_alive": bool(thread is not None and thread.is_alive()),
            "worker_restarts": restarts,
            "engines": engines,
            "devices": self._shards.device_health(),
            "queued": {lane: self._sched.depth(lane)
                       for lane in self._sched.lanes},
            "snapshot": snapshot,
        }

    # -- per-profile fused-engine health (the degraded-mode gate) -----------
    def _engine_state(self, name: str) -> Dict:
        # lint: unlocked(every caller already holds self._lock)
        return self._engine_health.setdefault(
            name, {"degraded": False, "fails": 0, "next_probe": 0.0})

    def _fused_allowed(self, name: str, now: float) -> Tuple[bool, bool]:
        """``(attempt fused?, is this attempt a recovery probe?)``."""
        with self._lock:
            st = self._engine_state(name)
            if not st["degraded"]:
                return True, False
            if now >= st["next_probe"]:
                # claim the probe slot so concurrent windows don't herd
                st["next_probe"] = now + self._engine_probe_s
                return True, True
            return False, False

    def _note_fused_ok(self, name: str) -> None:
        with self._lock:
            st = self._engine_state(name)
            if st["degraded"]:
                st["degraded"] = False
                self._stats.engine_recovered += 1
            st["fails"] = 0

    def _note_fused_failure(self, name: str) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._engine_state(name)
            st["fails"] += 1
            if st["fails"] >= self._fused_failure_threshold \
                    and not st["degraded"]:
                st["degraded"] = True
                st["next_probe"] = now + self._engine_probe_s
                self._stats.engine_degraded += 1
                _LOG.warning(
                    "profile %r demoted after %d consecutive fused "
                    "failures (probing back every %.1fs)", name,
                    st["fails"], self._engine_probe_s)

    # -- submission (any thread) --------------------------------------------
    def submit_design(self, spec: DataStructureSpec,
                      variant: DataStructureSpec, workload: Workload, hw,
                      mix: Optional[Dict[str, float]] = None,
                      session: Optional[str] = None,
                      deadline_s: Optional[float] = None,
                      lane: Optional[str] = None) -> Future:
        hw_name = self._profile_name(hw)
        ev = _Evaluation((spec, variant), workload, mix, hw_name, session)

        def finalize(elapsed: float) -> WhatIfAnswer:
            return WhatIfAnswer(question_design(spec, variant),
                                float(ev.totals[0]), float(ev.totals[1]),
                                elapsed)
        return self._submit([ev], finalize, session=session,
                            cost=request_cost(2), deadline_s=deadline_s,
                            lane=lane or INTERACTIVE)

    def submit_hardware(self, spec: DataStructureSpec, workload: Workload,
                        hw, new_hw,
                        mix: Optional[Dict[str, float]] = None,
                        session: Optional[str] = None,
                        deadline_s: Optional[float] = None,
                        lane: Optional[str] = None) -> Future:
        base_hw = self._profiles[self._profile_name(hw)]
        var_hw = self._profiles[self._profile_name(new_hw)]
        # identical (specs, workload, mix): both evaluations resolve to the
        # SAME packed frontier, scored under two profile groups — the
        # what-if-hardware table swap, now amortized across a whole batch
        base = _Evaluation((spec,), workload, mix, base_hw.name, session)
        var = _Evaluation((spec,), workload, mix, var_hw.name, session)

        def finalize(elapsed: float) -> WhatIfAnswer:
            return WhatIfAnswer(question_hardware(base_hw, var_hw),
                                float(base.totals[0]), float(var.totals[0]),
                                elapsed)
        return self._submit([base, var], finalize, session=session,
                            cost=request_cost(2), deadline_s=deadline_s,
                            lane=lane or INTERACTIVE)

    def submit_workload(self, spec: DataStructureSpec, workload: Workload,
                        new_workload: Workload, hw,
                        mix: Optional[Dict[str, float]] = None,
                        session: Optional[str] = None,
                        deadline_s: Optional[float] = None,
                        lane: Optional[str] = None) -> Future:
        hw_name = self._profile_name(hw)
        base = _Evaluation((spec,), workload, mix, hw_name, session)
        var = _Evaluation((spec,), new_workload, mix, hw_name, session)

        def finalize(elapsed: float) -> WhatIfAnswer:
            return WhatIfAnswer(question_workload(workload, new_workload),
                                float(base.totals[0]), float(var.totals[0]),
                                elapsed)
        return self._submit([base, var], finalize, session=session,
                            cost=request_cost(2), deadline_s=deadline_s,
                            lane=lane or INTERACTIVE)

    def submit_complete(self, partial: Sequence[Element],
                        workload: Workload, hw,
                        candidates: Optional[Sequence[Element]] = None,
                        terminals: Optional[Sequence[Element]] = None,
                        mix: Optional[Dict[str, float]] = None,
                        max_depth: int = 3, name: str = "auto",
                        session: Optional[str] = None,
                        deadline_s: Optional[float] = None,
                        lane: Optional[str] = None) -> Future:
        hw_name = self._profile_name(hw)
        # enumeration is structural and memoized — do it at submit time so
        # the whole window's frontiers are known when the batch closes
        frontier = enumerate_frontier(partial, candidates, terminals,
                                      max_depth, name)
        if not frontier:
            with self._lock:   # counted like any other failed question
                self._stats.questions += 1
                self._stats.failed += 1
            fut: Future = Future()
            fut.set_exception(RuntimeError("no valid completion found"))
            return fut
        ev = _Evaluation(frontier, workload, mix, hw_name, session)

        def finalize(elapsed: float) -> SearchResult:
            best = int(np.argmin(ev.totals))
            return SearchResult(frontier[best], float(ev.totals[best]),
                                len(frontier), elapsed)
        if lane is None:   # big completions ride the bulk lane
            lane = BULK if len(frontier) >= self._bulk_threshold \
                else INTERACTIVE
        return self._submit([ev], finalize, session=session,
                            cost=request_cost(len(frontier)),
                            deadline_s=deadline_s, lane=lane)

    def submit_sweep(self, specs: Sequence[DataStructureSpec],
                     workloads: Sequence[Workload], hw,
                     mixes=None,
                     session: Optional[str] = None,
                     deadline_s: Optional[float] = None,
                     lane: Optional[str] = None) -> Future:
        """A (designs x workloads) grid as one request.

        Sweeps over the same workload-point axis arriving in one
        coalescing window splice along the design axis and score as one
        fused sweep call (a distinct axis or profile starts its own
        group); the answer is a
        :class:`~repro_torch.core.whatif.WorkloadSweepAnswer`.  Sweeps ride
        the bulk lane and pay their whole (designs x points) grid in
        admission cells."""
        hw_name = self._profile_name(hw)
        specs = tuple(specs)
        points = normalize_points(workloads, mixes)
        ev = _Evaluation(specs, None, None, hw_name, session,
                         points=points)
        with self._lock:
            self._stats.sweeps += 1

        def finalize(elapsed: float) -> WorkloadSweepAnswer:
            return WorkloadSweepAnswer(
                question_sweep(points, len(specs)), specs, points,
                np.asarray(ev.totals), elapsed)
        return self._submit([ev], finalize, session=session,
                            cost=request_cost(len(specs), len(points)),
                            deadline_s=deadline_s, lane=lane or BULK)

    def submit_search(self, workload: Workload, hw,
                      mix: Optional[Dict[str, float]] = None, *,
                      budget_designs: int = 256,
                      workloads: Optional[Sequence[Workload]] = None,
                      mixes=None,
                      session: Optional[str] = None,
                      deadline_s: Optional[float] = None,
                      lane: Optional[str] = None,
                      **search_kwargs) -> Future:
        """Population-based design search as a served request.

        Runs :func:`repro_torch.core.search.population_search` with every
        generation's scoring routed through :meth:`submit_sweep` on the
        bulk lane — so population search rides the same admission
        control, priority lanes, per-request deadlines and
        degraded-engine fault-healing chain as any other sweep traffic
        (an interactive what-if never waits behind a generation's fused
        call, and a NaN-poisoned bank heals mid-search without the
        search noticing anything but the answer's engine tag).

        Admission is priced up front for the *whole* designs-costed
        budget (``request_cost(budget_designs, points)``); the inner
        per-generation sweeps then ride free of session budgets, so a
        search is charged exactly once.  ``deadline_s`` bounds the whole
        search: each generation's sweep gets the remaining slice and the
        loop itself stops with :class:`DeadlineExceeded` once spent.
        The future resolves to the ``population_search`` result dict —
        discrete winner, oracle-verified, budget accounting included.
        ``search_kwargs`` pass through (``population``, ``generations``,
        ``seed``, ``templates``, ...).
        """
        from repro_torch.core.search import (SearchBudget,
                                             population_search)
        thread = self._thread
        if thread is None or not thread.is_alive():
            raise RuntimeError("service is not running (call start())")
        hw_name = self._profile_name(hw)
        hw_profile = self._profiles[hw_name]
        wls = list(workloads) if workloads is not None else [workload]
        points = normalize_points(wls, mixes if mixes is not None else mix)
        with self._lock:
            self._stats.questions += 1
            self._stats.searches += 1
        if self._budgets is not None:
            try:
                self._budgets.admit(
                    session, request_cost(budget_designs, len(points)))
            except BudgetExceeded:
                with self._lock:
                    self._stats.budget_rejected += 1
                raise
        deadline_s = deadline_s if deadline_s is not None \
            else self._default_deadline
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        sweep_lane = lane or BULK
        fut: Future = Future()

        def score_fn(specs) -> np.ndarray:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    raise DeadlineExceeded(
                        "search deadline spent before the next "
                        "generation could score",
                        deadline_s=deadline_s, late_by_s=-remaining)
            # session=None: the search already paid its whole budget at
            # admission — generation sweeps must not double-charge it
            inner = self.submit_sweep(
                [s for s in specs], [w for w, _ in points], hw_profile,
                [dict(mi) for _, mi in points], session=None,
                deadline_s=remaining, lane=sweep_lane)
            # lint: untimed-wait(request deadline + supervisor bound the wait)
            answer = inner.result()
            return np.asarray(answer.totals, np.float64).mean(axis=0)

        def drive() -> None:
            if not fut.set_running_or_notify_cancel():
                return
            t0 = time.perf_counter()
            try:
                result = population_search(
                    workload, hw_profile, mix,
                    budget=SearchBudget(budget_designs),
                    workloads=wls,
                    mixes=mixes if mixes is not None else mix,
                    score_fn=score_fn, **search_kwargs)
            except Exception as exc:    # noqa: BLE001 — future carries it
                with self._lock:
                    self._stats.failed += 1
                fut.set_exception(exc)
                return
            with self._lock:
                self._stats.answered += 1
            result["elapsed_s"] = time.perf_counter() - t0
            fut.set_result(result)

        threading.Thread(target=drive, daemon=True,
                         name=f"repro-search-{id(fut):x}").start()
        return fut

    # -- synchronous conveniences -------------------------------------------
    # These deliberately block without a deadline: the request-level
    # deadline (deadline_s) plus the worker supervisor guarantee the
    # future resolves or fails, and stop() drains the queue.
    def what_if_design(self, *args, **kwargs) -> WhatIfAnswer:
        # lint: untimed-wait(request deadline + supervisor bound the wait)
        return self.submit_design(*args, **kwargs).result()

    def what_if_hardware(self, *args, **kwargs) -> WhatIfAnswer:
        # lint: untimed-wait(request deadline + supervisor bound the wait)
        return self.submit_hardware(*args, **kwargs).result()

    def what_if_workload(self, *args, **kwargs) -> WhatIfAnswer:
        # lint: untimed-wait(request deadline + supervisor bound the wait)
        return self.submit_workload(*args, **kwargs).result()

    def complete_design(self, *args, **kwargs) -> SearchResult:
        # lint: untimed-wait(request deadline + supervisor bound the wait)
        return self.submit_complete(*args, **kwargs).result()

    def workload_sweep(self, *args, **kwargs) -> WorkloadSweepAnswer:
        # lint: untimed-wait(request deadline + supervisor bound the wait)
        return self.submit_sweep(*args, **kwargs).result()

    def design_search(self, *args, **kwargs) -> Dict:
        # lint: untimed-wait(request deadline + supervisor bound the wait)
        return self.submit_search(*args, **kwargs).result()

    # -- the serving loop (worker thread) -----------------------------------
    def _submit(self, evals: List[_Evaluation],
                finalize: Callable[[float], object], *,
                lane: str = INTERACTIVE, cost: float = 1.0,
                session: Optional[str] = None,
                deadline_s: Optional[float] = None) -> Future:
        thread = self._thread
        if thread is None or not thread.is_alive():
            raise RuntimeError("service is not running (call start())")
        if not self._lanes_enabled:
            lane = INTERACTIVE          # FIFO baseline: one lane
        with self._lock:
            self._stats.questions += 1
        if self._budgets is not None:
            try:
                self._budgets.admit(session, cost)
            except BudgetExceeded:
                with self._lock:
                    self._stats.budget_rejected += 1
                raise
        deadline_s = deadline_s if deadline_s is not None \
            else self._default_deadline
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        fut: Future = Future()
        req = _Request(evals, finalize, fut, time.perf_counter(),
                       lane=lane, deadline=deadline, deadline_s=deadline_s,
                       cost=cost)
        try:
            self._sched.put(req, lane)
        except RejectedError:
            with self._lock:
                if lane == BULK:
                    self._stats.shed_bulk += 1
                else:
                    self._stats.shed_interactive += 1
            raise
        except ServiceStoppedError:
            with self._lock:
                self._stats.stopped_requests += 1
            raise
        # close the submit/stop race: if the worker died between the check
        # above and the put, nothing will ever serve the queue — fail the
        # stragglers (including ours) instead of hanging their futures
        if not thread.is_alive():
            self._fail_pending()
        return fut

    def _supervise(self) -> None:
        """Worker supervision: run the coalescing loop, resurrect it.

        A crash in the loop (a bug, a poisoned batch, an injected
        ``service.worker`` fault) used to be swallowed per-batch; now it
        propagates here, the in-flight window's futures fail with the
        typed :class:`~repro_torch.serving.admission.WorkerCrashed`, and the
        loop restarts with exponential backoff — up to
        ``max_worker_restarts`` times, after which the service closes
        admission and fails everything still queued rather than
        restart-looping forever."""
        while True:
            try:
                self._loop()
                return                      # orderly CLOSED shutdown
            except BaseException as exc:    # noqa: BLE001 — supervisor
                with self._lock:
                    self._stats.worker_restarts += 1
                    restarts = self._stats.worker_restarts
                self._crash_inflight(exc, restarts)
                if restarts > self._max_worker_restarts:
                    _LOG.error(
                        "serving worker crashed %d times (limit %d); "
                        "giving up: %r", restarts,
                        self._max_worker_restarts, exc)
                    self._sched.close()
                    self._fail_pending()
                    return
                _LOG.warning(
                    "serving worker crashed (%r); restart %d/%d",
                    exc, restarts, self._max_worker_restarts)
                time.sleep(min(self._worker_backoff_s * 2 ** (restarts - 1),
                               1.0))

    def _crash_inflight(self, exc: BaseException, restarts: int) -> None:
        """Fail the crashed window's in-flight futures with WorkerCrashed."""
        inflight, self._inflight = self._inflight, []
        for req in inflight:
            if req.future.done():
                continue
            self._count("failed")
            req.future.set_exception(WorkerCrashed(
                f"serving worker crashed mid-window ({exc!r}); the "
                f"request was not served and will not be replayed — "
                f"resubmit if still wanted", cause=exc, restarts=restarts))

    def _loop(self) -> None:
        while True:
            head = self._sched.get()
            if head is CLOSED:
                return
            if head is None:       # defensive: untimed get never times out
                continue
            batch = [head]
            bulk_taken = 1 if head.lane == BULK else 0
            closing = False
            deadline = time.monotonic() + self._window
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                allowed = None
                if self._bulk_per_window is not None \
                        and bulk_taken >= self._bulk_per_window:
                    # this window's bulk share is spent: keep accepting
                    # interactive arrivals only; queued bulk waits for
                    # the next window
                    allowed = (INTERACTIVE,)
                nxt = self._sched.get(timeout=remaining, lanes=allowed)
                if nxt is None:
                    break
                if nxt is CLOSED:
                    closing = True
                    break
                if nxt.lane == BULK:
                    bulk_taken += 1
                batch.append(nxt)
            # in-flight tracking for the supervisor: a crash anywhere in
            # _serve_batch fails exactly this window's unresolved futures
            # with WorkerCrashed instead of hanging them (the old blanket
            # per-batch except hid crashes from restart accounting)
            self._inflight = batch
            self._serve_batch(batch)
            self._inflight = []
            if closing:
                return

    def _pack(self, ev: _Evaluation) -> PackedFrontier:
        chains = tuple(s.chain for s in ev.specs)
        if ev.points is not None:
            key: Tuple = (chains, ev.points)
        else:
            mix_key = tuple(ev.mix.items()) if ev.mix else None
            key = (chains, ev.workload, mix_key)
        with self._lock:
            state = self._sessions.get(ev.session) if ev.session else None
        if state is not None:
            packed = state.get(key)
            if packed is not None:
                with self._lock:
                    self._stats.session_frontier_hits += 1
                return packed
        if ev.points is not None:
            packed = pack_sweep(ev.specs, [p[0] for p in ev.points],
                                [dict(p[1]) for p in ev.points])
        else:
            packed = pack_frontier(ev.specs, ev.workload, ev.mix)
        if state is not None:
            state.put(key, packed)
        return packed

    def _expire(self, req: _Request, now: float) -> None:
        """Fail a request whose deadline passed before it finished."""
        req.dead = True
        late = now - req.deadline
        self._count("expired")
        req.future.set_exception(DeadlineExceeded(
            f"deadline of {req.deadline_s:.3f}s exceeded before serving "
            f"({late * 1e3:.1f} ms late)",
            deadline_s=req.deadline_s or 0.0, late_by_s=late))

    def _count(self, outcome: str) -> None:
        """One request's outcome counted, before its future resolves: a
        client that reads ``stats()`` once its answer arrives sees it
        counted."""
        with self._lock:
            setattr(self._stats, outcome, getattr(self._stats, outcome) + 1)

    def _finalize(self, req: _Request) -> None:
        """Resolve one fully-scored request, counted first."""
        try:
            for ev in req.evals:
                if ev.error is not None:
                    raise ev.error
            answer = req.finalize(time.perf_counter() - req.t0)
            # tag the answer with the engine(s) that actually produced it
            # (fused / fused-flat / grouped), so clients and the chaos
            # bench can see when a degraded path served them
            engines = sorted({ev.engine for ev in req.evals if ev.engine})
            if engines and hasattr(answer, "engine"):
                answer.engine = engines[0] if len(engines) == 1 \
                    else ",".join(engines)
        except Exception as exc:
            self._count("failed")
            req.future.set_exception(exc)
            return
        self._count("answered")
        req.future.set_result(answer)

    def _score_group(self, evals: List[_Evaluation], hw: HardwareProfile,
                     points, probe: Callable[[int], bool],
                     deadline: Optional[float]
                     ) -> Optional[Tuple[int, int]]:
        """Score one (profile, axis) group through the degraded-engine
        fallback chain: fused-sharded -> fused-flat -> grouped oracle,
        the last on the CPU only.

        Fused results are validated with a cheap ``isfinite`` reduction
        (NaN-poisoned parameter banks produce *finite-looking shapes*
        with garbage values — the one failure a shape check misses).  A
        fused failure falls back to the flat fused call (same banks, no
        shard pool — isolating device trouble from bank corruption);
        when that also fails but the grouped oracle answers, the profile
        is demoted to the oracle until a timed fused probe — which first
        drops the possibly-poisoned device banks
        (:func:`repro_torch.core.devicecost.invalidate_table`) — succeeds.
        When the oracle *also* rejects the request, that is a request
        problem, not an engine problem: the oracle's exception surfaces
        and the profile is not demoted.

        On the card the oracle (host numpy) never answers.  A group that
        fails both fused calls fails its futures with the first fused
        error, and the profile is demoted unless the error was the
        request's own (``KeyError``, ``ValueError``, ``TypeError``).  A
        demoted profile's questions fail with :class:`FusedEngineDown`
        until its probe, which drops the banks, scores fused again.

        Returns ``(score_calls, shard_dispatches)`` — ``(0, 0)`` when
        the group failed with every evaluation's ``error`` set — or
        ``None`` when every owner expired before a scoring call ran.
        """
        if points is not None:
            product = concat_sweeps([ev.packed for ev in evals])
            pool_call = self._shards.score_sweep
        else:
            product = concat_frontiers([ev.packed for ev in evals])
            pool_call = self._shards.score_frontier

        def finish(result, engine: str, used: int = 1) -> Tuple[int, int]:
            offset = 0
            for ev in evals:
                if points is not None:
                    n = ev.packed.n_designs
                    ev.totals = result[:, offset:offset + n]
                else:
                    n = ev.packed.n_segments
                    ev.totals = result[offset:offset + n]
                ev.engine = engine
                offset += n
            return 1, used if used > 1 else 0

        if self._engine != "fused":     # grouped-engine service: no chain
            try:
                result, used = pool_call(product, hw, engine=self._engine,
                                         before_dispatch=probe,
                                         deadline=deadline)
            except Exception as exc:
                for ev in evals:
                    ev.error = exc
                return 0, 0
            if result is None:
                return None
            return finish(result, self._engine, used)

        attempt, probing = self._fused_allowed(hw.name, time.monotonic())
        if not attempt and not self._oracle_fallback:
            down = FusedEngineDown(
                f"the fused engine for {hw.name!r} failed on "
                f"{self._shards.devices[0]}; its recovery probe rebuilds "
                f"the banks within {self._engine_probe_s:.1f}s")
            for ev in evals:
                ev.error = down
            return 0, 0
        fused_failures = 0
        first_error: Optional[Exception] = None
        if attempt:
            if probing:
                # recovery probe: drop the (possibly NaN-poisoned) banks
                # so the probe scores from freshly built device tables
                devicecost.invalidate_table(hw)
            try:
                result, used = pool_call(product, hw, engine="fused",
                                         before_dispatch=probe,
                                         deadline=deadline)
                if result is None:
                    return None
                if not np.isfinite(result).all():
                    raise NonFiniteScore(
                        f"merged fused totals for {hw.name!r} contain "
                        f"non-finite values")
                self._note_fused_ok(hw.name)
                return finish(result, "fused", used)
            except Exception as exc:    # noqa: BLE001 — chain continues
                fused_failures += 1
                first_error = exc
                if isinstance(exc, NonFiniteScore):
                    with self._lock:
                        self._stats.nonfinite_groups += 1
                _LOG.warning("fused sharded scoring failed for %r (%r); "
                             "retrying flat", hw.name, exc)
            if not probe(0):
                return None
            try:
                flat = product.score(hw, engine="fused", shard=False)
                if not np.isfinite(np.asarray(flat)).all():
                    raise NonFiniteScore(
                        f"flat fused totals for {hw.name!r} contain "
                        f"non-finite values")
                # flat success means the banks are fine: the sharded
                # failure was device/shard trouble (the pool's breaker
                # handles that) — engine health resets, no demotion
                self._note_fused_ok(hw.name)
                with self._lock:
                    self._stats.fallback_flat += 1
                return finish(flat, "fused-flat")
            except Exception as exc:    # noqa: BLE001 — chain continues
                fused_failures += 1
                if isinstance(exc, NonFiniteScore):
                    with self._lock:
                        self._stats.nonfinite_groups += 1
                _LOG.warning("flat fused scoring failed for %r (%r)",
                             hw.name, exc)
            if not self._oracle_fallback:
                # on the card: no host answer; fail the group, and demote
                # the profile unless the request itself was at fault
                if not isinstance(first_error,
                                  (KeyError, ValueError, TypeError)):
                    for _ in range(fused_failures):
                        self._note_fused_failure(hw.name)
                for ev in evals:
                    ev.error = first_error
                return 0, 0
        # grouped oracle: the last resort, and the whole path while the
        # profile is degraded
        if not probe(0):
            return None
        try:
            result = product.score(hw, engine="grouped")
        except Exception as exc:
            # the oracle rejected the request too: a request problem, not
            # an engine problem — surface the (more diagnostic) original
            # fused error when there was one, and don't demote the profile
            for ev in evals:    # each group keeps its own failure
                ev.error = first_error if first_error is not None else exc
            return 0, 0
        for _ in range(fused_failures):     # oracle fine, fused broken
            self._note_fused_failure(hw.name)
        with self._lock:
            self._stats.fallback_grouped += 1
        return finish(result, "grouped")

    def _serve_batch(self, batch: List[_Request]) -> None:
        """Answer one coalescing window: splice every evaluation into one
        frontier per (hardware profile, sweep-point axis), score each
        group with one fused call, slice the per-design totals (or
        per-grid columns) back out, resolve the futures.

        With lanes enabled, groups containing interactive requests score
        first and every request's future resolves as soon as its last
        evaluation is scored — an interactive answer never waits on a
        bulk group's fused call.  Deadlines are checked here (the
        dequeue point) and again before every scoring call."""
        if not batch:
            with self._lock:
                self._stats.empty_windows += 1
            return
        # fault seam: a rule on "service.worker" crashes the loop here,
        # exercising the supervisor's restart + WorkerCrashed path
        faults.check("service.worker", len(batch))
        groups: Dict[Tuple, List[_Evaluation]] = {}
        live: List[_Request] = []
        now = time.monotonic()
        cancelled = 0
        for req in batch:
            # Future-based cancel: a request cancelled before the worker
            # picked it up is dropped without packing or scoring
            if not req.future.set_running_or_notify_cancel():
                cancelled += 1
                continue
            if req.deadline is not None and now > req.deadline:
                self._expire(req, now)
                continue
            try:
                for ev in req.evals:
                    ev.owner = req
                    ev.packed = self._pack(ev)
            except Exception as exc:
                self._count("failed")
                req.future.set_exception(exc)
                continue
            req.remaining = len(req.evals)
            for ev in req.evals:
                groups.setdefault((ev.hw_name, ev.points), []).append(ev)
            live.append(req)

        def _rank(item) -> Tuple[int, int]:
            (_, points), evals = item
            interactive = any(ev.owner.lane == INTERACTIVE for ev in evals)
            return (0 if interactive else 1, 0 if points is None else 1)

        ordered = sorted(groups.items(), key=_rank) \
            if self._lanes_enabled else list(groups.items())
        score_calls = shard_dispatches = 0
        for (hw_name, points), evals in ordered:
            # deadline re-check between coalesced scoring calls: expired
            # requests fail fast instead of occupying this fused call
            now = time.monotonic()
            for ev in evals:
                req = ev.owner
                if not req.dead and req.deadline is not None \
                        and now > req.deadline:
                    self._expire(req, now)
            evals = [ev for ev in evals if not ev.owner.dead]
            if not evals:
                continue
            hw = self._profiles[hw_name]

            def _probe(shard_idx: int, _evals=evals) -> bool:
                """Deadline check between shard dispatches (the
                between-scoring-calls contract, extended inside one
                sharded call); False once no owner is left alive."""
                now = time.monotonic()
                alive = False
                for ev in _evals:
                    req = ev.owner
                    if not req.dead and req.deadline is not None \
                            and now > req.deadline:
                        self._expire(req, now)
                    alive = alive or not req.dead
                return alive

            # the window's part-wait bound: the furthest-out owner
            # deadline — unless some owner is deadline-free, in which
            # case only the pool's own part_timeout_s bounds the wait
            deadline = None
            if all(ev.owner.deadline is not None for ev in evals):
                deadline = max(ev.owner.deadline for ev in evals)
            outcome = self._score_group(evals, hw, points, _probe,
                                        deadline)
            if outcome is None:   # every owner expired mid-dispatch
                continue
            calls, used = outcome
            score_calls += calls
            shard_dispatches += used
            for ev in evals:
                req = ev.owner
                if req.dead:   # expired by a mid-dispatch probe
                    continue
                req.remaining -= 1
                if req.remaining == 0 and self._lanes_enabled:
                    # eager resolution: the future resolves the moment
                    # its last group scored, ahead of later bulk groups
                    self._finalize(req)
        for req in live:   # FIFO mode, plus any defensive leftovers
            if req.dead or req.future.done():
                continue
            self._finalize(req)
        with self._lock:
            st = self._stats
            st.batches += 1
            st.score_calls += score_calls
            st.shard_dispatches += shard_dispatches
            st.cancelled += cancelled
            st.max_batch = max(st.max_batch, len(batch))
            if len(batch) > 1:
                st.coalesced += len(batch)
