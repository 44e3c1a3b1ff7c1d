"""Port vs reference: admission control, priority lanes, deadlines,
overload shedding, cancellation and shutdown (the twin of
``tests/test_admission.py``) on the CPU.

Scheduler/bucket mechanics are tested pure (no scoring) and held
against the reference's scheduler on the same sequence of calls;
service-level behaviour runs real questions through a live worker.  The
contract: overload *rejects* (typed, immediately — never blocks, never
deadlocks), bulk traffic cannot starve interactive questions, deadlines
fail fast, and shutdown is distinguishable from shedding.  No test here
rests on a tight wall-clock margin: waits are seconds where a loaded
CPU takes milliseconds.
"""
import threading
import time

import numpy as np
import pytest

from repro import serving as r_serving
from repro.core import elements as r_el, hardware as r_hw
from repro.core.synthesis import Workload as RWorkload
from repro_torch import runtime
from repro_torch.core import elements as el
from repro_torch.core.hardware import hw1, hw2
from repro_torch.core.synthesis import Workload
from repro_torch.serving import (BULK, INTERACTIVE, BudgetExceeded,
                                 DeadlineExceeded, DesignCalculatorService,
                                 LaneScheduler, RejectedError,
                                 ServiceStoppedError, SessionBudgets,
                                 TokenBucket, request_cost)
from repro_torch.serving.lanes import CLOSED
from repro_torch.serving.service import _Evaluation, _Request

pytestmark = pytest.mark.load


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield

W = Workload(n_entries=100_000, n_queries=100)


# ---------------------------------------------------------------------------
# Cost pricing and token buckets (pure)
# ---------------------------------------------------------------------------
def test_request_cost_is_cells():
    assert request_cost(2) == 2.0
    assert request_cost(64, 8) == 512.0
    # degenerate sizes still price at one cell
    assert request_cost(0) == 1.0
    assert request_cost(0, 0) == 1.0


def test_token_bucket_burst_and_refill():
    clock = [0.0]
    bucket = TokenBucket(capacity=10, refill_per_s=5,
                         clock=lambda: clock[0])
    assert bucket.try_acquire(8)
    assert not bucket.try_acquire(4)      # 2 left
    clock[0] = 1.0                        # +5 tokens
    assert bucket.available() == pytest.approx(7.0)
    assert bucket.try_acquire(7)
    clock[0] = 100.0                      # refill caps at capacity
    assert bucket.available() == pytest.approx(10.0)


def test_token_bucket_rejects_bad_config():
    with pytest.raises(ValueError):
        TokenBucket(capacity=0, refill_per_s=1)
    with pytest.raises(ValueError):
        TokenBucket(capacity=1, refill_per_s=0)


def test_session_budgets_are_isolated():
    clock = [0.0]
    budgets = SessionBudgets(capacity=4, refill_per_s=0.001,
                             clock=lambda: clock[0])
    budgets.admit("alice", 4)
    with pytest.raises(BudgetExceeded) as exc:
        budgets.admit("alice", 4)         # alice is dry...
    assert exc.value.session == "alice"
    assert exc.value.cost == 4
    budgets.admit("bob", 4)               # ...bob is unaffected
    # sessionless traffic shares one anonymous bucket
    budgets.admit(None, 4)
    with pytest.raises(BudgetExceeded) as exc:
        budgets.admit(None, 1)
    assert exc.value.session == SessionBudgets.ANONYMOUS
    # BudgetExceeded is a RejectedError: one handler catches both sheds
    assert issubclass(BudgetExceeded, RejectedError)


# ---------------------------------------------------------------------------
# Lane scheduler (pure)
# ---------------------------------------------------------------------------
def test_lane_overflow_rejects_immediately_not_deadlocks():
    sched = LaneScheduler(capacities={INTERACTIVE: 2, BULK: 1})
    assert sched.put("i1") == 0
    assert sched.put("i2") == 1
    t0 = time.monotonic()
    with pytest.raises(RejectedError) as exc:
        sched.put("i3")                   # full lane must shed NOW
    assert time.monotonic() - t0 < 5.0    # no wait for a free slot
    assert exc.value.lane == INTERACTIVE
    assert exc.value.depth == 2 and exc.value.limit == 2
    sched.put("b1", BULK)
    with pytest.raises(RejectedError):
        sched.put("b2", BULK)
    # the full lanes drained normally afterwards
    assert [sched.get(0.1) for _ in range(3)].count(None) == 0


def test_weighted_round_robin_and_priority():
    sched = LaneScheduler(weights={INTERACTIVE: 2, BULK: 1})
    for i in range(4):
        sched.put(f"i{i}")
    for i in range(4):
        sched.put(f"b{i}", BULK)
    order = [sched.get(0.1) for _ in range(8)]
    # 2 interactive : 1 bulk while both lanes hold work
    assert order[:6] == ["i0", "i1", "b0", "i2", "i3", "b1"]
    # interactive drained: bulk flows at full rate
    assert order[6:] == ["b2", "b3"]


def test_bulk_flood_cannot_starve_interactive():
    sched = LaneScheduler()
    for i in range(50):
        sched.put(f"b{i}", BULK)
    sched.put("urgent")
    # the interactive arrival is served ahead of the 50-deep bulk backlog
    assert sched.get(0.1) == "urgent"


def test_restricted_get_skips_other_lanes():
    sched = LaneScheduler()
    sched.put("b0", BULK)
    # only-bulk queued + interactive-only request -> timeout, not bulk
    assert sched.get(0.05, lanes=(INTERACTIVE,)) is None
    sched.put("i0")
    assert sched.get(0.05, lanes=(INTERACTIVE,)) == "i0"
    assert sched.get(0.05) == "b0"


def test_close_sheds_then_drains_then_reports_closed():
    sched = LaneScheduler()
    sched.put("i0")
    sched.put("b0", BULK)
    sched.close()
    with pytest.raises(ServiceStoppedError) as exc:
        sched.put("i1")
    assert exc.value.queue_position == 1   # behind i0
    # queued work still drains after close, then CLOSED
    assert sched.get(0.1) == "i0"
    assert sched.get(0.1) == "b0"
    assert sched.get(0.1) is CLOSED
    # a restricted get never reports CLOSED while other lanes hold work
    sched.reopen()
    sched.put("b1", BULK)
    sched.close()
    assert sched.get(0.05, lanes=(INTERACTIVE,)) is None
    assert sched.get(0.05) == "b1"


def test_drain_reports_positions():
    sched = LaneScheduler()
    for name in ("i0", "i1"):
        sched.put(name)
    sched.put("b0", BULK)
    drained = sched.drain()
    assert drained == [("i0", INTERACTIVE, 0), ("i1", INTERACTIVE, 1),
                       ("b0", BULK, 0)]
    assert sched.depth() == 0


# ---------------------------------------------------------------------------
# Service-level behavior (live worker)
# ---------------------------------------------------------------------------
def _svc(*hws, **kwargs):
    kwargs.setdefault("window_s", 0.002)
    return DesignCalculatorService(list(hws), **kwargs)


def test_budget_exhaustion_sheds_at_submit():
    h1 = hw1()
    svc = _svc(h1, budget_cells=2, budget_refill_per_s=1e-6)
    try:
        spec, variant = el.spec_btree(), el.spec_btree(fanout=40)
        svc.what_if_design(spec, variant, W, h1)       # 2 cells: admitted
        with pytest.raises(BudgetExceeded):
            svc.what_if_design(spec, variant, W, h1)   # bucket is dry
        stats = svc.stats()
        assert stats["budget_rejected"] == 1
        assert stats["answered"] == 1
    finally:
        svc.stop()


def test_zero_capacity_bulk_lane_sheds_sweeps_but_serves_whatifs():
    h1 = hw1()
    svc = _svc(h1, bulk_capacity=0)
    try:
        with pytest.raises(RejectedError) as exc:
            svc.submit_sweep([el.spec_btree()], [W], h1)
        assert exc.value.lane == BULK
        spec, variant = el.spec_btree(), el.spec_btree(fanout=40)
        answer = svc.what_if_design(spec, variant, W, h1)
        assert answer.baseline_seconds > 0
        stats = svc.stats()
        assert stats["shed_bulk"] == 1 and stats["shed_interactive"] == 0
    finally:
        svc.stop()


def test_expired_deadline_fails_fast_with_deadline_exceeded():
    h1 = hw1()
    svc = _svc(h1)
    try:
        spec, variant = el.spec_btree(), el.spec_btree(fanout=40)
        svc.what_if_design(spec, variant, W, h1)       # warm the caches
        fut = svc.submit_design(spec, variant, W, h1, deadline_s=0.0)
        with pytest.raises(DeadlineExceeded) as exc:
            fut.result(timeout=30)
        assert exc.value.late_by_s >= 0.0
        assert svc.stats()["expired"] == 1
    finally:
        svc.stop()


def test_deadline_rechecked_between_scoring_groups(monkeypatch):
    """A request that expires while an earlier group scores is failed at
    the between-groups check, not served late.  Driven deterministically
    through ``_serve_batch`` with a scripted clock."""
    import concurrent.futures

    from repro_torch.serving import service as service_mod

    h1, h2 = hw1(), hw2()
    svc = DesignCalculatorService([h1, h2], start=False)
    spec = el.spec_btree()
    ev1 = _Evaluation((spec,), W, None, h1.name)
    ev2 = _Evaluation((spec,), W, None, h2.name)
    fut = concurrent.futures.Future()
    # expires at t=50: alive at batch assembly (t=0), dead by the time
    # the second group is reached (t=100)
    req = _Request([ev1, ev2], lambda elapsed: (ev1.totals, ev2.totals),
                   fut, 0.0, deadline=50.0, deadline_s=50.0)
    ticks = iter([0.0, 100.0, 100.0, 100.0])
    real = time.monotonic
    monkeypatch.setattr(service_mod.time, "monotonic",
                        lambda: next(ticks, real()))
    svc._serve_batch([req])
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=0)
    assert svc.stats()["expired"] == 1


def test_cancel_before_serving_skips_scoring():
    import concurrent.futures

    h1 = hw1()
    svc = DesignCalculatorService([h1], start=False)
    ev = _Evaluation((el.spec_btree(),), W, None, h1.name)
    fut = concurrent.futures.Future()
    req = _Request([ev], lambda elapsed: ev.totals, fut, 0.0)
    assert fut.cancel()
    svc._serve_batch([req])
    assert ev.packed is None               # never packed, never scored
    assert svc.stats()["cancelled"] == 1


def test_stop_fails_stragglers_with_queue_position():
    import concurrent.futures

    h1 = hw1()
    svc = DesignCalculatorService([h1], start=False)
    futs = [concurrent.futures.Future() for _ in range(3)]
    for i, fut in enumerate(futs):
        ev = _Evaluation((el.spec_btree(),), W, None, h1.name)
        svc._sched.put(_Request([ev], lambda e: None, fut, 0.0))
    svc._fail_pending()
    for i, fut in enumerate(futs):
        with pytest.raises(ServiceStoppedError) as exc:
            fut.result(timeout=0)
        assert exc.value.queue_position == i
    assert svc.stats()["stopped_requests"] == 3


def test_submit_during_shutdown_gets_service_stopped_error():
    h1 = hw1()
    svc = _svc(h1)
    spec, variant = el.spec_btree(), el.spec_btree(fanout=40)
    svc.what_if_design(spec, variant, W, h1)
    svc._sched.close()                     # shutdown has begun
    with pytest.raises(ServiceStoppedError):
        svc.submit_design(spec, variant, W, h1)
    assert svc.stats()["stopped_requests"] == 1
    svc.stop()


def test_interactive_answers_resolve_before_bulk_groups():
    """With lanes on, an interactive future must resolve even though a
    bulk sweep shares (and dominates) its coalescing window."""
    h1 = hw1()
    specs = [el.spec_btree(fanout=8 + 2 * i) for i in range(16)]
    workloads = [W, Workload(n_entries=100_000, n_queries=100,
                             zipf_alpha=1.0)]
    svc = _svc(h1, window_s=0.05)
    try:
        spec, variant = el.spec_btree(), el.spec_btree(fanout=40)
        svc.what_if_design(spec, variant, W, h1)        # warm + compile
        svc.workload_sweep(specs, workloads, h1)
        sweep_fut = svc.submit_sweep(specs, workloads, h1)
        what_fut = svc.submit_design(spec, variant, W, h1)
        what_fut.result(timeout=30)
        sweep_fut.result(timeout=30)
        stats = svc.stats()
        assert stats["failed"] == 0
        assert stats["answered"] >= 4
    finally:
        svc.stop()


def test_lane_routing_by_request_kind():
    h1 = hw1()
    svc = _svc(h1, bulk_threshold=2, bulk_capacity=0)
    try:
        # a >=2-design completion routes to the (zero-capacity) bulk lane
        with pytest.raises(RejectedError):
            svc.submit_complete((el.spec_btree().chain[0],), W, h1,
                                max_depth=2)
        # explicit lane override forces it back to interactive
        res = svc.complete_design((el.spec_btree().chain[0],), W, h1,
                                  max_depth=2, lane=INTERACTIVE)
        assert res.explored >= 2
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Port against reference
# ---------------------------------------------------------------------------
def test_request_cost_and_buckets_match_reference():
    for args in [(2,), (64, 8), (0,), (0, 0), (3466, 64), (1, 1)]:
        assert request_cost(*args) == r_serving.request_cost(*args)
    clock = [0.0]
    ours = TokenBucket(capacity=10, refill_per_s=5, clock=lambda: clock[0])
    theirs = r_serving.TokenBucket(capacity=10, refill_per_s=5,
                                   clock=lambda: clock[0])
    for t, cost in [(0.0, 8), (0.0, 4), (1.0, 7), (1.5, 3), (100.0, 10),
                    (100.0, 1)]:
        clock[0] = t
        assert ours.try_acquire(cost) == theirs.try_acquire(cost)
        assert ours.available() == theirs.available()


def test_lane_schedule_matches_reference():
    """The same puts, closes and gets give the same order, rejections and
    positions in both schedulers."""
    def drive(sched_cls, rejected_cls, stopped_cls, closed):
        sched = sched_cls(capacities={INTERACTIVE: 6, BULK: 3},
                          weights={INTERACTIVE: 3, BULK: 1})
        log = []
        for i in range(12):
            lane = BULK if i % 3 == 2 else INTERACTIVE
            try:
                log.append(("put", sched.put(f"r{i}", lane)))
            except rejected_cls as exc:
                log.append(("shed", exc.lane, exc.depth, exc.limit))
        log += [("get", sched.get(0.05)) for _ in range(4)]
        sched.close()
        try:
            sched.put("late")
        except stopped_cls as exc:
            log.append(("stopped", exc.queue_position))
        while True:
            item = sched.get(0.05)
            if item is closed or item is None:
                break
            log.append(("get", item))
        return log

    ours = drive(LaneScheduler, RejectedError, ServiceStoppedError, CLOSED)
    theirs = drive(r_serving.LaneScheduler, r_serving.RejectedError,
                   r_serving.ServiceStoppedError, r_serving.lanes.CLOSED)
    assert ours == theirs


def test_budgeted_service_matches_reference():
    """One session budget, the same questions: both services admit and
    shed the same requests, with answers within 1e-6."""
    spec_p, var_p = el.spec_btree(), el.spec_btree(fanout=40)
    spec_r, var_r = r_el.spec_btree(), r_el.spec_btree(fanout=40)
    w_r = RWorkload(n_entries=100_000, n_queries=100)
    outcomes = []
    for service_cls, hw, spec, variant, wl, shed in (
            (DesignCalculatorService, hw1(), spec_p, var_p, W,
             BudgetExceeded),
            (r_serving.DesignCalculatorService, r_hw.hw1(), spec_r, var_r,
             w_r, r_serving.BudgetExceeded)):
        svc = service_cls([hw], window_s=0.002, budget_cells=5,
                          budget_refill_per_s=1e-6)
        try:
            got = []
            for _ in range(4):
                try:
                    ans = svc.what_if_design(spec, variant, wl, hw,
                                             session="s")
                    got.append((ans.baseline_seconds, ans.variant_seconds,
                                ans.engine))
                except shed:
                    got.append("shed")
            stats = svc.stats()
        finally:
            svc.stop()
        outcomes.append((got, {k: stats[k] for k in (
            "questions", "answered", "failed", "budget_rejected")}))
    (ours, our_stats), (theirs, their_stats) = outcomes
    assert our_stats == their_stats
    assert [o == "shed" for o in ours] == [t == "shed" for t in theirs]
    for o, t in zip(ours, theirs):
        if o != "shed":
            np.testing.assert_allclose(o[:2], t[:2], rtol=1e-6)
            assert o[2] == t[2] == "fused"
