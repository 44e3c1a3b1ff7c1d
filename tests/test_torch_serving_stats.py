"""The serving tier's counters against its futures: every outcome is
counted before the future that reports it resolves, so a client that
reads ``stats()`` the moment its answer (or its error) arrives sees it
counted.  A done-callback runs at the resolution itself, on the worker
thread, which is the earliest any client can look; before the counts
moved ahead of the resolutions, a loaded host could deschedule the
worker between the two and a caller that had joined every client
thread read ``answered`` one short.
"""
import pytest

from repro_torch import runtime
from repro_torch.core import elements as el
from repro_torch.core.hardware import analytical_profile, hw1
from repro_torch.core.synthesis import Workload
from repro_torch.serving import DesignCalculatorService

W = Workload(n_entries=200_000, n_queries=100)


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def test_an_answer_is_counted_before_its_future_resolves():
    h1 = hw1()
    seen = []
    with DesignCalculatorService([h1], window_s=0.0, max_batch=1) as svc:
        for i in range(3):
            fut = svc.submit_design(el.spec_btree(), el.spec_csb_tree(), W,
                                    h1)
            fut.add_done_callback(
                lambda f: seen.append(svc.stats()["answered"]))
            fut.result()
    assert seen == [1, 2, 3]


def test_a_failure_is_counted_before_its_future_resolves():
    """A question on a profile that lacks a model fails in its window."""
    h1 = hw1()
    bad = analytical_profile("HW-bad")
    del bad.models["random_memory_access"]
    seen = []
    with DesignCalculatorService([h1], window_s=0.0, max_batch=1) as svc:
        svc.register_hardware(bad)
        fut = svc.submit_design(el.spec_btree(), el.spec_csb_tree(), W, bad)
        fut.add_done_callback(lambda f: seen.append(svc.stats()["failed"]))
        with pytest.raises(KeyError, match="no fitted"):
            fut.result()
    assert seen == [1]
