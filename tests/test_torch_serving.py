"""Port vs reference: the concurrent what-if service (the twin of
``tests/test_serving.py`` and of the two ``service`` tests of
``tests/test_search.py``) on the CPU.

Inside the port: answers within 1e-6 of the scalar oracle under
coalescing, sessions, threads and degenerate traffic, and no new K0
specialisation across hardware-swap requests.  Against the reference:
the same questions, asked of both services over the same profiles
(the port's loaded from the reference's profile JSON), give costs within
1e-6 relative and the same verdicts, engines, designs, designs explored
and counters.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro import serving as r_serving
from repro.core import elements as r_el, hardware as r_hw
from repro.core import search as r_search, whatif as r_wi
from repro.core.synthesis import Workload as RWorkload
from repro_torch import runtime
from repro_torch.core import batchcost, devicecost, elements as el, whatif
from repro_torch.core import search
from repro_torch.core.hardware import (HardwareProfile, analytical_profile,
                                       hw1, hw2, hw3)
from repro_torch.core.synthesis import Workload, cost_workload
from repro_torch.serving import DesignCalculatorService

W = Workload(n_entries=200_000, n_queries=100)
SKEWED = dataclasses.replace(W, zipf_alpha=1.5)
GROWN = dataclasses.replace(W, n_entries=800_000)
MIX = {"get": 80.0, "update": 20.0}


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


@pytest.fixture()
def profiles():
    return hw1(), hw2(), hw3()


@pytest.fixture()
def hw_analytical():
    return hw1()


def _service(profiles, **kwargs):
    kwargs.setdefault("window_s", 0.002)
    return DesignCalculatorService(list(profiles), **kwargs)


def _mixed_questions(h1, h2, h3, el=el, whatif=whatif, w=W, skewed=SKEWED,
                     grown=GROWN):
    """(kind, *args) tuples covering all three what-if kinds, several
    specs, two workload variants and two hardware swaps."""
    specs = [el.spec_btree(), el.spec_hash_table(), el.spec_skip_list(),
             el.spec_trie()]
    bloomed = whatif.add_bloom_filters(el.spec_hash_table())
    qs = []
    for i, spec in enumerate(specs):
        qs.append(("design", spec, bloomed, w, h1))
        qs.append(("hardware", spec, w, h1, (h2, h3)[i % 2]))
        qs.append(("workload", spec, w, (skewed, grown)[i % 2], h2))
    return qs


def _ask(service, q):
    kind = q[0]
    if kind == "design":
        return service.what_if_design(*q[1:])
    if kind == "hardware":
        return service.what_if_hardware(*q[1:])
    return service.what_if_workload(*q[1:])


def _scalar(q):
    fn = {"design": whatif.what_if_design,
          "hardware": whatif.what_if_hardware,
          "workload": whatif.what_if_workload}[q[0]]
    return fn(*q[1:], engine="scalar")


def _assert_matches(got, oracle):
    assert got.baseline_seconds == pytest.approx(
        oracle.baseline_seconds, rel=1e-6)
    assert got.variant_seconds == pytest.approx(
        oracle.variant_seconds, rel=1e-6)
    assert got.beneficial == oracle.beneficial
    assert got.question == oracle.question


# ---------------------------------------------------------------------------
# The reference's service tests, on the port
# ---------------------------------------------------------------------------
def test_service_answers_match_scalar_oracle(profiles):
    h1, h2, h3 = profiles
    with _service(profiles) as svc:
        for q in _mixed_questions(h1, h2, h3):
            got = _ask(svc, q)
            _assert_matches(got, _scalar(q))
            assert got.engine == "fused"


def test_service_grouped_engine_parity(profiles):
    h1, h2, h3 = profiles
    with _service(profiles, engine="grouped") as svc:
        q = ("design", el.spec_btree(), el.spec_csb_tree(), W, h1)
        got = _ask(svc, q)
        oracle = _scalar(q)
        assert got.baseline_seconds == pytest.approx(
            oracle.baseline_seconds, rel=1e-9)
        assert got.variant_seconds == pytest.approx(
            oracle.variant_seconds, rel=1e-9)
        assert got.engine == "grouped"


def test_service_complete_design_matches_direct(profiles):
    from repro_torch.core.autocomplete import complete_design
    h1, _, _ = profiles
    with _service(profiles) as svc:
        got = svc.complete_design((), W, h1, mix={"get": 100.0},
                                  max_depth=2)
    direct = complete_design((), W, h1, mix={"get": 100.0}, max_depth=2)
    assert got.cost_seconds == pytest.approx(direct.cost_seconds, rel=1e-6)
    assert got.explored == direct.explored
    assert got.spec.describe() == direct.spec.describe()


def test_service_complete_design_no_completion_fails_future(profiles):
    h1, _, _ = profiles
    with _service(profiles) as svc:
        # a non-terminal element as the only "terminal" admits no chain
        fut = svc.submit_complete((), W, h1,
                                  terminals=[el.hash_element(100)],
                                  max_depth=1)
        with pytest.raises(RuntimeError, match="no valid completion"):
            fut.result()


def test_concurrent_mixed_questions_match_scalar_oracle(profiles):
    """N threads issuing mixed design / hardware / workload questions
    through the service all match the serial scalar oracle to 1e-6, and
    no question asks for a new K0 specialisation — hardware-swap requests
    included."""
    h1, h2, h3 = profiles
    questions = _mixed_questions(h1, h2, h3)
    oracles = [_scalar(q) for q in questions]
    with _service(profiles, window_s=0.0, max_batch=1) as svc:
        for q in questions:            # warm pass
            _ask(svc, q)
        specs_before = devicecost.specialisation_count()
        n_threads = 4
        results = [[None] * len(questions) for _ in range(n_threads)]
        errors = []

        def worker(slot):
            try:
                for i, q in enumerate(questions):
                    results[slot][i] = _ask(svc, q)
            except Exception as exc:   # pragma: no cover - failure path
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert devicecost.specialisation_count() == specs_before
        for per_thread in results:
            for got, oracle in zip(per_thread, oracles):
                _assert_matches(got, oracle)
        stats = svc.stats()
        assert stats["answered"] == (n_threads + 1) * len(questions)
        assert stats["failed"] == 0


def test_burst_coalesces_into_few_batches(profiles):
    h1, h2, h3 = profiles
    questions = _mixed_questions(h1, h2, h3) * 3
    with _service(profiles, window_s=0.25,
                  max_batch=len(questions)) as svc:
        _ask(svc, questions[0])        # warm so the batch serves quickly
        futures = [getattr(svc, f"submit_{q[0]}")(*q[1:])
                   for q in questions]
        for f in futures:
            f.result()
        stats = svc.stats()
    assert stats["coalesced"] >= len(questions)
    assert stats["batches"] <= 1 + len(questions) // 4
    assert stats["score_calls"] < len(questions)
    assert stats["max_batch"] > 1


def test_session_pins_frontiers_across_global_cache_clears(profiles):
    h1, _, _ = profiles
    spec, variant = el.spec_btree(), el.spec_csb_tree()
    with _service(profiles) as svc:
        sess = svc.session("designer-1")
        first = sess.what_if_design(spec, variant, W, h1)
        assert svc.stats()["session_frontier_hits"] == 0
        batchcost.clear_caches()       # simulate eviction by other traffic
        again = sess.what_if_design(spec, variant, W, h1)
        assert svc.stats()["session_frontier_hits"] == 1
        assert batchcost.cache_info()["packed_spec"].misses == 0
        assert again.baseline_seconds == pytest.approx(
            first.baseline_seconds, rel=1e-12)
        other = svc.session("designer-2")
        other.what_if_design(spec, variant, W, h1)
        assert svc.stats()["session_frontier_hits"] == 1


def test_empty_window_and_empty_frontier_tolerated(profiles):
    h1, _, _ = profiles
    with _service(profiles) as svc:
        svc._serve_batch([])           # an empty coalescing window
        assert svc.stats()["empty_windows"] == 1
        from concurrent.futures import Future
        from repro_torch.serving.service import _Evaluation, _Request
        ev = _Evaluation((), W, None, h1.name)
        fut = Future()
        svc._serve_batch([_Request([ev], lambda el_: ev.totals, fut, 0.0)])
        assert fut.result().shape == (0,)


def test_failed_question_does_not_poison_the_batch(profiles):
    h1, _, _ = profiles
    bad_hw = analytical_profile("HW-bad")
    del bad_hw.models["random_memory_access"]
    with _service(profiles) as svc:
        svc.register_hardware(bad_hw)
        good = svc.submit_design(el.spec_btree(), el.spec_csb_tree(), W, h1)
        bad = svc.submit_design(el.spec_btree(), el.spec_csb_tree(), W,
                                bad_hw)
        with pytest.raises(KeyError, match="no fitted"):
            bad.result()
        assert good.result().baseline_seconds > 0
        assert svc.stats()["failed"] == 1


def test_submit_after_stop_raises(profiles):
    h1, _, _ = profiles
    svc = _service(profiles)
    svc.stop()
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit_hardware(el.spec_btree(), W, h1, h1)


def test_unregistered_profile_name_raises(profiles):
    with _service(profiles) as svc:
        with pytest.raises(KeyError, match="unregistered"):
            svc.submit_hardware(el.spec_btree(), W, "HW1", "HW-unknown")


def test_stop_drains_pending_requests(profiles):
    h1, h2, _ = profiles
    svc = _service(profiles, window_s=0.05)
    futures = [svc.submit_hardware(el.spec_btree(), W, h1, h2)
               for _ in range(8)]
    svc.stop(timeout=60.0)
    for f in futures:
        assert f.result().baseline_seconds > 0


def test_session_state_lru_safe_under_concurrent_threads():
    """Hammered get/put/evict never tears the session pins' LRU
    bookkeeping and respects ``maxsize`` throughout."""
    import time as _time
    from repro_torch.serving.service import _SessionState

    state = _SessionState(maxsize=8)
    errors = []
    stop = threading.Event()

    def hammer(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                key = int(rng.integers(0, 32))
                if rng.random() < 0.5:
                    state.put(key, object())
                else:
                    state.get(key)
                assert len(state.frontiers) <= state.maxsize
        except Exception as exc:   # pragma: no cover - the regression
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    _time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    assert len(state.frontiers) <= state.maxsize


def test_service_submit_search_matches_direct(hw_analytical):
    workload = Workload(n_entries=1_000_000, n_queries=100)
    direct = search.population_search(
        workload, hw_analytical, MIX, budget=search.SearchBudget(48),
        population=8, generations=20, seed=4)
    with DesignCalculatorService([hw_analytical]) as svc:
        answer = svc.submit_search(
            workload, hw_analytical, MIX, budget_designs=48,
            population=8, generations=20, seed=4).result(timeout=300)
        assert svc.stats()["searches"] == 1
    assert answer["cost_s"] == direct["cost_s"]
    assert answer["design"].chain == direct["design"].chain
    oracle = cost_workload(answer["design"], workload, hw_analytical, MIX)
    assert abs(oracle - answer["cost_s"]) / oracle <= search.ORACLE_RTOL


def test_service_submit_search_deadline(hw_analytical):
    from repro_torch.serving.admission import DeadlineExceeded
    workload = Workload(n_entries=1_000_000, n_queries=100)
    with DesignCalculatorService([hw_analytical]) as svc:
        fut = svc.submit_search(
            workload, hw_analytical, MIX, budget_designs=512,
            population=16, generations=200, seed=0,
            deadline_s=1e-4)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=300)


# ---------------------------------------------------------------------------
# Port against reference: the same questions asked of both services
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shared_profiles(tmp_path_factory):
    """The reference's hw1-hw3 and the port's, loaded from the JSON the
    reference wrote."""
    root = tmp_path_factory.mktemp("profiles")
    ref, port = [], []
    for make in (r_hw.hw1, r_hw.hw2, r_hw.hw3):
        hw = make()
        path = str(root / f"{hw.name}.json")
        hw.save(path)
        ref.append(r_hw.HardwareProfile.load(path))
        port.append(HardwareProfile.load(path))
    return ref, port


def _burst(svc, questions):
    futures = []
    for q in questions:
        if q[0] == "complete":
            futures.append(svc.submit_complete(q[1], q[2], q[3],
                                               max_depth=q[4]))
        else:
            futures.append(getattr(svc, f"submit_{q[0]}")(*q[1:]))
    return [f.result(timeout=300) for f in futures]


def test_coalesced_burst_matches_reference(shared_profiles):
    """A mixed burst with auto-completions, coalesced into one window by
    each service: costs within 1e-6, the same verdicts, engines, chosen
    designs and designs explored, and the same serving counters."""
    (r1, r2, r3), (p1, p2, p3) = shared_profiles
    w_r = RWorkload(n_entries=200_000, n_queries=100)
    sides = []
    for el_mod, wi_mod, wl, hws, service_cls in (
            (el, whatif, W, (p1, p2, p3), DesignCalculatorService),
            (r_el, r_wi, w_r, (r1, r2, r3),
             r_serving.DesignCalculatorService)):
        questions = _mixed_questions(
            *hws, el=el_mod, whatif=wi_mod, w=wl,
            skewed=dataclasses.replace(wl, zipf_alpha=1.5),
            grown=dataclasses.replace(wl, n_entries=800_000))
        questions += [("complete", (), wl, hws[i], 2) for i in range(3)]
        svc = service_cls(list(hws), window_s=0.25,
                          max_batch=len(questions))
        try:
            answers = _burst(svc, questions)
            stats = svc.stats()
        finally:
            svc.stop()
        sides.append((answers, stats))
    (ours, our_stats), (theirs, their_stats) = sides
    for got, want in zip(ours, theirs):
        assert got.engine == want.engine == "fused"
        if hasattr(want, "explored"):
            assert got.spec.describe() == want.spec.describe()
            assert got.explored == want.explored
            np.testing.assert_allclose(got.cost_seconds, want.cost_seconds,
                                       rtol=1e-6)
            continue
        assert got.question == want.question
        assert got.beneficial == want.beneficial
        np.testing.assert_allclose(
            [got.baseline_seconds, got.variant_seconds],
            [want.baseline_seconds, want.variant_seconds], rtol=1e-6)
    for key in ("questions", "answered", "failed", "batches", "score_calls",
                "coalesced", "max_batch", "fallback_flat",
                "fallback_grouped", "shard_dispatches"):
        assert our_stats[key] == their_stats[key], key


def test_sweep_and_search_match_reference(shared_profiles):
    """``submit_sweep`` over a read-fraction axis and ``submit_search``:
    grids within 1e-6 with the same argmins, the same winner."""
    (_, _, r3), (_, _, p3) = shared_profiles
    fractions = np.linspace(0.0, 1.0, 5)
    w_p, w_r = Workload(n_entries=1_000_000), RWorkload(n_entries=1_000_000)
    kw = dict(budget_designs=48, population=8, generations=20, seed=4)
    with DesignCalculatorService([p3], window_s=0.002) as svc:
        sweep = svc.workload_sweep(
            [el.spec_btree(), el.spec_trie(), el.spec_hash_table(),
             el.spec_skip_list()], [w_p] * 5, p3,
            whatif.read_fraction_mixes(fractions))
        found = svc.submit_search(w_p, p3, MIX, **kw).result(timeout=300)
    with r_serving.DesignCalculatorService([r3], window_s=0.002) as svc:
        want = svc.workload_sweep(
            [r_el.spec_btree(), r_el.spec_trie(), r_el.spec_hash_table(),
             r_el.spec_skip_list()], [w_r] * 5, r3,
            r_wi.read_fraction_mixes(fractions))
        want_found = svc.submit_search(w_r, r3, MIX, **kw).result(
            timeout=300)
    np.testing.assert_allclose(sweep.totals, want.totals, rtol=1e-6)
    np.testing.assert_array_equal(sweep.best_indices, want.best_indices)
    assert sweep.engine == want.engine == "fused"
    assert found["design"].describe() == want_found["design"].describe()
    assert found["designs_costed"] == want_found["designs_costed"]
    np.testing.assert_allclose(found["cost_s"], want_found["cost_s"],
                               rtol=1e-6)
    assert r_search.ORACLE_RTOL == search.ORACLE_RTOL
