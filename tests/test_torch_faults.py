"""Port vs reference: the fault-injection harness and the serving tier's
self-healing paths (the twin of ``tests/test_faults.py``) on the CPU.

Every failure path the port's serving tier claims to survive is
exercised deterministically: part retry on a different slot, slot
quarantine and half-open probe recovery, the fused -> flat -> grouped
degraded-engine chain (against the scalar oracle) and, on the card, the
same chain without the host oracle, worker resurrection
with typed ``WorkerCrashed`` futures, part timeouts with
abandoned-future accounting, and snapshot-restore outcome counters.
Two CPU slots (``devices=["cpu", "cpu"]``) stand in for the reference's
forced host devices.  Unlike the reference's, no test here rests on a
tight wall-clock margin: every path is warmed before it is timed, a hang
is several times the part timeout, the part timeout is seconds where a
loaded part takes milliseconds, and probe and quarantine windows are
seconds long.  The seeded decisions of a plan equal the reference's.
"""
import time

import numpy as np
import pytest
import torch

from repro.testing import faults as r_faults
from repro_torch import runtime
from repro_torch.core import devicecost, elements as el, whatif
from repro_torch.core.batchcost import pack_frontier
from repro_torch.core.hardware import HardwareProfile, hw1
from repro_torch.core.synthesis import Workload, cost_workload
from repro_torch.serving import (DesignCalculatorService, FusedEngineDown,
                                 NonFiniteScore, ScoringShardPool,
                                 WorkerCrashed)
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultInjected, FaultPlan, FaultRule

pytestmark = pytest.mark.chaos

W = Workload(n_entries=150_000, n_queries=100)
MIX = {"get": 60.0, "range_get": 20.0, "update": 20.0}
#: a part on a loaded CPU takes milliseconds; seconds are far beyond it
PART_TIMEOUT_S = 2.0


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _packed():
    return pack_frontier([el.spec_btree(), el.spec_hash_table(),
                          el.spec_skip_list(), el.spec_trie()], W, MIX)


def _service(hw, **kwargs):
    kwargs.setdefault("window_s", 0.002)
    return DesignCalculatorService([hw], **kwargs)


# ---------------------------------------------------------------------------
# The harness itself
# ---------------------------------------------------------------------------
def test_fault_plan_is_seed_deterministic():
    def pattern(seed):
        plan = FaultPlan(seed, [FaultRule("x", kind="error", rate=0.5)])
        hits = []
        with plan.activate():
            for _ in range(200):
                try:
                    faults.check("x", key="k")
                    hits.append(0)
                except FaultInjected:
                    hits.append(1)
        return hits, plan.fires()

    first, fires = pattern(42)
    again, fires2 = pattern(42)
    assert first == again and fires == fires2
    assert 40 < fires < 160    # rate=0.5 actually fires, and not always


def test_fault_plan_decisions_match_reference():
    """The same seed, rules and crossings fire at the same places in both
    packages' harnesses."""
    def pattern(mod):
        plan = mod.FaultPlan(7, [
            mod.FaultRule("shards.dispatch", kind="error", rate=0.3),
            mod.FaultRule("devicecost.fused", kind="corrupt", at=(2, 5)),
            mod.FaultRule("shards.dispatch", kind="error", key=1,
                          rate=1.0, max_fires=2)])
        hits = []
        with plan.activate():
            for i in range(60):
                try:
                    mod.check("shards.dispatch", i % 3)
                    hits.append("ok")
                except mod.FaultInjected:
                    hits.append("error")
                out = mod.corrupt("devicecost.fused", np.ones(2))
                hits.append(bool(np.isnan(out).any()))
        return hits, plan.counts()

    assert pattern(faults) == pattern(r_faults)


def test_seams_are_noops_without_a_plan():
    assert faults.active() is None
    faults.check("anything", key=7)     # must not raise
    value = np.ones(3)
    assert faults.corrupt("anything", value) is value


def test_only_one_plan_active_per_process():
    with FaultPlan(0, []).activate():
        with pytest.raises(RuntimeError, match="already active"):
            with FaultPlan(1, []).activate():
                pass
    faults.check("fine")    # the seams are clean again


def test_corrupt_poisons_float_leaves_only():
    plan = FaultPlan(0, [FaultRule("s", kind="corrupt", rate=1.0)])
    banks = {"f": np.arange(3, dtype=np.float64),
             "i": np.arange(3, dtype=np.int32),
             "tf": torch.arange(3, dtype=torch.float32),
             "ti": torch.arange(3, dtype=torch.int32)}
    with plan.activate():
        out = faults.corrupt("s", banks)
    assert np.isnan(out["f"]).all() and torch.isnan(out["tf"]).all()
    assert np.array_equal(out["i"], banks["i"])   # gather indices intact
    assert torch.equal(out["ti"], banks["ti"])


# ---------------------------------------------------------------------------
# Shard pool healing
# ---------------------------------------------------------------------------
def test_failed_part_retries_on_a_different_slot():
    pool = ScoringShardPool(devices=["cpu", "cpu"],
                            part_timeout_s=PART_TIMEOUT_S)
    hw = hw1()
    packed = _packed()
    baseline = packed.score(hw, engine="fused", shard=False)
    plan = FaultPlan(3, [FaultRule("shards.dispatch", kind="error",
                                   key=0, at=(0,))])
    try:
        with plan.activate():
            totals, used = pool.score_frontier(packed, hw)
        assert used == 1                 # 4 designs: one part
        assert np.array_equal(totals, baseline)
        assert pool.stats()["shard_retries"] == 1
        retries = [e for e in pool.recent_events() if e[0] == "retry"]
        assert retries and all(frm != to for _, _, frm, to in retries)
    finally:
        pool.close()


def test_quarantine_opens_and_half_open_probe_recovers():
    quarantine_s = 3.0
    pool = ScoringShardPool(1, devices=["cpu"], quarantine_after=2,
                            quarantine_s=quarantine_s,
                            part_timeout_s=PART_TIMEOUT_S)
    hw = hw1()
    packed = _packed()
    baseline = packed.score(hw, engine="fused", shard=False)
    # exactly two dispatch failures: initial + same-slot retry -> the
    # breaker opens; the flat rescore still answers the window
    plan = FaultPlan(5, [FaultRule("shards.dispatch", kind="error",
                                   rate=1.0, max_fires=2)])
    try:
        with plan.activate():
            totals, _ = pool.score_frontier(packed, hw)
            assert np.array_equal(totals, baseline)
            stats = pool.stats()
            assert stats["shard_rescored"] == 1
            assert stats["device_quarantines"] == 1
            health = pool.device_health()[0]
            assert health["state"] == "quarantined"
            assert health["consecutive_failures"] == 2
            time.sleep(quarantine_s + 0.2)
            assert pool.device_health()[0]["state"] == "half-open"
            # next pick is the probe; the rule is spent, so it succeeds
            totals, _ = pool.score_frontier(packed, hw)
        assert np.array_equal(totals, baseline)
        stats = pool.stats()
        assert stats["device_probes"] >= 1
        assert stats["device_recoveries"] == 1
        assert pool.device_health()[0]["state"] == "ok"
        kinds = [e[0] for e in pool.recent_events()]
        assert ["quarantine", "probe", "recover"] == \
            [k for k in kinds if k != "retry"]
    finally:
        pool.close()


def test_hung_part_times_out_and_is_abandoned():
    pool = ScoringShardPool(1, devices=["cpu"],
                            part_timeout_s=PART_TIMEOUT_S)
    hw = hw1()
    packed = _packed()
    baseline = packed.score(hw, engine="fused", shard=False)
    # warm the executor path (a rule-free plan forces it) so the timing
    # below measures healing, not first-use work
    with FaultPlan(0, []).activate():
        pool.score_frontier(packed, hw)
    hang_s = 4 * PART_TIMEOUT_S
    plan = FaultPlan(9, [FaultRule("shards.dispatch", kind="hang",
                                   rate=1.0, hang_s=hang_s, max_fires=1)])
    try:
        with plan.activate():
            t0 = time.monotonic()
            totals, _ = pool.score_frontier(packed, hw)
        assert time.monotonic() - t0 < hang_s - 1.0   # did not wait it out
        assert np.array_equal(totals, baseline)
        stats = pool.stats()
        assert stats["shard_timeouts"] == 1
        assert stats["abandoned_parts"] == 1   # uncancellable, accounted
        assert stats["shard_retries"] == 1
    finally:
        pool.close()


def test_corrupt_fused_output_heals_inside_the_pool():
    hw = hw1()
    with _service(hw, shard_part_timeout_s=PART_TIMEOUT_S * 10) as svc:
        q = (el.spec_btree(), el.spec_csb_tree(), W, hw)
        svc.what_if_design(*q)                  # warm
        plan = FaultPlan(11, [FaultRule("devicecost.fused",
                                        kind="corrupt", at=(0,))])
        with plan.activate():
            got = svc.what_if_design(*q)
        assert plan.fires("devicecost.fused") == 1
        oracle = whatif.what_if_design(*q, engine="scalar")
        assert got.baseline_seconds == pytest.approx(
            oracle.baseline_seconds, rel=1e-6)
        assert got.variant_seconds == pytest.approx(
            oracle.variant_seconds, rel=1e-6)
        # healed below the engine chain: the retried dispatch was clean
        assert got.engine == "fused"
        stats = svc.stats()
        assert stats["shard_nonfinite"] >= 1
        assert stats["shard_retries"] >= 1
        assert stats["fallback_grouped"] == 0


# ---------------------------------------------------------------------------
# Degraded-engine fallback chain
# ---------------------------------------------------------------------------
def test_nan_banks_fall_back_to_oracle_then_probe_recovers():
    probe_s = 3.0
    hw = hw1()
    with _service(hw, engine_probe_s=probe_s,
                  shard_part_timeout_s=PART_TIMEOUT_S * 10) as svc:
        q = (el.spec_btree(), el.spec_csb_tree(), W, hw)
        oracle = whatif.what_if_design(*q, engine="scalar")
        # poison the NEXT bank build (the live table must be dropped for
        # the corruption to reach the scorer), then ask
        devicecost.invalidate_table(hw)
        plan = FaultPlan(13, [FaultRule("devicecost.banks",
                                        kind="corrupt", rate=1.0,
                                        max_fires=1)])
        with plan.activate():
            got = svc.what_if_design(*q)
        demoted = time.monotonic()
        assert plan.fires("devicecost.banks") == 1
        assert got.engine == "grouped"
        assert got.baseline_seconds == pytest.approx(
            oracle.baseline_seconds, rel=1e-9)
        assert got.variant_seconds == pytest.approx(
            oracle.variant_seconds, rel=1e-9)
        stats = svc.stats()
        assert stats["nonfinite_groups"] >= 2
        assert stats["fallback_grouped"] == 1
        assert stats["engine_degraded"] == 1
        health = svc.health()["engines"][hw.name]
        assert health["degraded"] and health["engine"] == "grouped"
        # still inside the probe window: the oracle keeps serving
        got2 = svc.what_if_design(*q)
        assert time.monotonic() - demoted < probe_s
        assert got2.engine == "grouped"
        assert svc.stats()["fallback_grouped"] == 2
        time.sleep(probe_s + 0.2)
        # probe window open: the fused attempt rebuilds clean banks
        # (invalidate_table) and succeeds -> recovery
        got3 = svc.what_if_design(*q)
        assert got3.engine == "fused"
        assert got3.baseline_seconds == pytest.approx(
            oracle.baseline_seconds, rel=1e-6)
        stats = svc.stats()
        assert stats["engine_recovered"] == 1
        assert not svc.health()["engines"][hw.name]["degraded"]


def test_nan_banks_on_the_card_fail_the_question_then_probe_recovers():
    """On the card the grouped oracle (host numpy) never answers: a group
    whose fused calls both fail fails its future, the profile is refused
    until its probe, and the probe's fresh banks bring the fused engine
    back.  The CPU service is told it stands on the card."""
    probe_s = 3.0
    hw = hw1()
    with _service(hw, engine_probe_s=probe_s,
                  shard_part_timeout_s=PART_TIMEOUT_S * 10) as svc:
        svc._oracle_fallback = False
        q = (el.spec_btree(), el.spec_csb_tree(), W, hw)
        oracle = whatif.what_if_design(*q, engine="scalar")
        devicecost.invalidate_table(hw)
        plan = FaultPlan(13, [FaultRule("devicecost.banks",
                                        kind="corrupt", rate=1.0,
                                        max_fires=1)])
        with plan.activate():
            with pytest.raises(NonFiniteScore):
                svc.what_if_design(*q)
        demoted = time.monotonic()
        assert plan.fires("devicecost.banks") == 1
        stats = svc.stats()
        assert stats["nonfinite_groups"] >= 2
        assert stats["fallback_grouped"] == 0 and stats["failed"] == 1
        assert stats["engine_degraded"] == 1
        health = svc.health()["engines"][hw.name]
        assert health["degraded"] and health["engine"] == "down"
        with pytest.raises(FusedEngineDown):
            svc.what_if_design(*q)
        assert time.monotonic() - demoted < probe_s
        time.sleep(probe_s + 0.2)
        back = svc.what_if_design(*q)
        assert back.engine == "fused"
        assert back.baseline_seconds == pytest.approx(
            oracle.baseline_seconds, rel=1e-6)
        stats = svc.stats()
        assert stats["engine_recovered"] == 1
        assert stats["fallback_grouped"] == 0 and stats["failed"] == 2


def test_request_error_on_the_card_does_not_demote():
    """A question the profile cannot answer (a model it never fitted)
    fails on its own; the fused engine stays up."""
    hw = hw1()
    partial = HardwareProfile("HW1-partial", {
        k: v for k, v in hw.models.items() if k != "random_memory_access"})
    with _service(partial) as svc:
        svc._oracle_fallback = False
        with pytest.raises(KeyError):
            svc.what_if_design(el.spec_btree(), el.spec_csb_tree(), W,
                               partial)
        stats = svc.stats()
        assert stats["engine_degraded"] == 0 and stats["failed"] == 1
        assert not svc.health()["engines"].get(
            partial.name, {"degraded": False})["degraded"]


# ---------------------------------------------------------------------------
# Worker supervision
# ---------------------------------------------------------------------------
def test_worker_crash_fails_inflight_typed_and_resurrects():
    hw = hw1()
    with _service(hw) as svc:
        q = (el.spec_btree(), el.spec_csb_tree(), W, hw)
        plan = FaultPlan(17, [FaultRule("service.worker", kind="error",
                                        at=(0,))])
        with plan.activate():
            fut = svc.submit_design(*q)
            with pytest.raises(WorkerCrashed) as err:
                fut.result(timeout=60)
        assert isinstance(err.value.cause, FaultInjected)
        assert err.value.restarts == 1
        got = svc.what_if_design(*q)
        oracle = whatif.what_if_design(*q, engine="scalar")
        assert got.baseline_seconds == pytest.approx(
            oracle.baseline_seconds, rel=1e-6)
        assert svc.stats()["worker_restarts"] == 1
        assert svc.health()["worker_alive"]


# ---------------------------------------------------------------------------
# Snapshot-restore outcomes
# ---------------------------------------------------------------------------
def test_corrupt_snapshot_is_counted_and_cold_starts(tmp_path):
    path = tmp_path / "snap.pkl"
    path.write_bytes(b"this is not a pickle")
    hw = hw1()
    with _service(hw, snapshot_path=str(path)) as svc:
        stats = svc.stats()
        assert stats["snapshot_corrupt"] == 1
        assert stats["snapshot_discarded"] == 1
        assert stats["snapshot_entries"] == 0
        assert svc.health()["snapshot"]["outcome"] == "corrupt"
        q = (el.spec_btree(), el.spec_csb_tree(), W, hw)
        assert svc.what_if_design(*q).baseline_seconds == pytest.approx(
            cost_workload(el.spec_btree(), W, hw), rel=1e-6)


def test_restored_snapshot_is_counted(tmp_path):
    path = tmp_path / "snap.pkl"
    hw = hw1()
    with _service(hw, snapshot_path=str(path)) as svc:
        svc.what_if_design(el.spec_btree(), el.spec_csb_tree(), W, hw)
        assert svc.save_snapshot() > 0
    with _service(hw, snapshot_path=str(path)) as svc:
        stats = svc.stats()
        assert stats["snapshot_restored"] == 1
        assert stats["snapshot_discarded"] == 0
        assert stats["snapshot_entries"] > 0
        assert svc.health()["snapshot"]["outcome"] == "restored"
        got = svc.what_if_design(el.spec_btree(), el.spec_csb_tree(), W,
                                 hw)
        assert got.engine == "fused"
