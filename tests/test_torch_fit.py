"""Port vs reference: the fitting half of the Level-2 cost models and the
training pass (``core/models.py`` ``fit``/``fit2d_sigmoids``,
``core/training.py``), on the CPU.

The recovery cases mirror ``tests/test_cost_models.py`` with its
thresholds.  Parity: the same seeded ``(x, y)`` go through both
packages' ``fit``.  The sigmoid initialization is numpy in both and must
be bit-identical; kinds and ``x_range`` are exact.

**The tolerance on fitted predictions, and why.**  Both fitters end with
constant-learning-rate Adam (lr 3e-3 for the linear bases, 2e-2 for the
sigmoids, in units standardized by ``max |y|``).  Adam does not settle
at constant lr: near the optimum its step is ``lr * m / sqrt(v)``, a
fraction of lr whatever the gradient's size, so the last steps jitter
the parameters by up to ~lr in standardized units, and float32 rounding
decides which way.  XLA and torch round the loss's reductions
differently, so the two packages' final parameters differ by that
jitter.  The reference is no steadier against itself: refitting its own
``test_cost_models`` sigmoid data moved by one float32 ulp moves its
predictions by 2.0e-3 of ``max |y|``, and its log-loglog case by 8.4e-4
(measured on the CPU when this test was written).  Port against
reference on the same data the largest difference seen was 1.7e-3 of
``max |y|`` (the bloom-probe sigmoid of the training pass below).  So
predictions are held within ``FIT_ATOL = 5e-3`` of ``max |y|``, absolute
at every size: a pointwise relative bound cannot hold where the fitted
intercept, a jitter-sized number, is most of a small prediction.  The
fits' quality (r^2) must agree to 1e-3.
"""
import inspect
import zlib

import numpy as np
import pytest
import torch

from repro.core import access as r_access
from repro.core import autocomplete as r_ac
from repro.core import elements as r_el
from repro.core import hardware as r_hw
from repro.core import models as r_models
from repro.core import search as r_search
from repro.core import synthesis as r_syn
from repro.core import training as r_training
from repro_torch import runtime
from repro_torch.core import autocomplete as p_ac
from repro_torch.core import elements as p_el
from repro_torch.core import hardware as p_hw
from repro_torch.core import models as p_models
from repro_torch.core import search as p_search
from repro_torch.core import structures as S
from repro_torch.core import synthesis as p_syn
from repro_torch.core import training as p_training

#: fitted predictions: absolute, as a share of max |y| (module docstring)
FIT_ATOL = 5e-3
#: r^2 of the two fits on the same data
R2_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _r2(model, x, y):
    return p_models.r2_score(y, model.predict(x))


def _assert_fits_agree(port, ref, x, y, what=""):
    assert port.kind == ref.kind
    assert port.x_range == ref.x_range
    assert set(port.params) == set(ref.params)
    for k, v in port.params.items():
        assert v.dtype == np.float32 and v.shape == ref.params[k].shape, k
    got, want = port.predict(x), ref.predict(x)
    scale = float(np.max(np.abs(np.asarray(y, np.float32))))
    worst = float(np.max(np.abs(got - want))) / scale
    assert worst <= FIT_ATOL, f"{what}: {worst:.3e} of max|y|"
    assert abs(p_models.r2_score(y, got) - r_models.r2_score(y, want)) \
        <= R2_ATOL, what


# ---------------------------------------------------------------------------
# Recovery, as tests/test_cost_models.py holds the reference
# ---------------------------------------------------------------------------
def _step_data():
    x = np.logspace(2, 8, 60)
    logx = np.log(x + 1.0)

    def step(c, x0):
        return c / (1 + np.exp(-8.0 * (logx - np.log(x0))))
    return x, 1e-9 + step(4e-9, 4e3) + step(2e-8, 2e5) + step(7e-8, 2e7)


_LINEAR_X = np.logspace(1, 6, 24)
RECOVERY = {
    "linear": ("linear", _LINEAR_X, 3e-9 * _LINEAR_X + 2e-7, 0.999),
    "log_linear": ("log_linear", _LINEAR_X,
                   5e-8 * np.log(_LINEAR_X) + 1e-7, 0.99),
    "nlogn": ("nlogn", _LINEAR_X,
              2e-9 * _LINEAR_X * np.log(_LINEAR_X) + 5e-9 * _LINEAR_X,
              0.99),
    "log_loglog": ("log_loglog", _LINEAR_X,
                   2e-9 * _LINEAR_X + 1e-8 * np.log(_LINEAR_X)
                   + 3e-8 * np.log(np.log(_LINEAR_X) + 1.0), 0.99),
    "sigmoids": ("sigmoids",) + _step_data() + (0.98,),
}


@pytest.mark.parametrize("case", sorted(RECOVERY))
def test_fit_recovers_and_matches_reference(case):
    kind, x, y, threshold = RECOVERY[case]
    port = p_models.fit(kind, x, y)
    assert _r2(port, x, y) > threshold
    _assert_fits_agree(port, r_models.fit(kind, x, y), x, y, case)
    if kind == "sigmoids":
        # prediction is monotone non-decreasing (a step function)
        assert np.all(np.diff(port.predict(x)) >= -1e-12)


def test_nnls_weights_match_reference():
    """The linear-basis weights themselves, not only their predictions:
    each within FIT_ATOL of its own size's share of the prediction
    (``w_j * max |phi_j|`` over ``max |y|``), and never negative."""
    rng = np.random.default_rng(5)
    x = np.logspace(1, 7, 40)
    for basis, cols in (("linear", [x]),
                        ("log_linear", [x, np.log(x + 1.0)]),
                        ("nlogn", [x * np.log(x + 1.0), x])):
        y = sum(c * s for c, s in zip(cols, (2e-9, 3e-8)[:len(cols)]))
        y = y * (1 + 0.02 * rng.standard_normal(len(x))) + 1e-7
        port, ref = p_models.fit(basis, x, y), r_models.fit(basis, x, y)
        assert (port.params["w"] >= 0).all() and port.params["y0"] >= 0
        span = np.asarray([np.max(np.abs(c)) for c in cols])
        scale = np.max(np.abs(y))
        dw = np.abs(port.params["w"] - ref.params["w"]) * span / scale
        assert dw.max() <= FIT_ATOL, (basis, dw)
        assert abs(port.params["y0"] - ref.params["y0"]) / scale <= FIT_ATOL


def test_knn_fit_is_exact():
    x = np.logspace(1, 5, 20)
    y = 1e-8 * np.sqrt(x)
    port, ref = p_models.fit("knn", x, y), r_models.fit("knn", x, y)
    assert _r2(port, x, y) > 0.95
    for k in ("x", "y"):
        np.testing.assert_array_equal(port.params[k], ref.params[k])
    assert port.x_range == ref.x_range


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sigmoid_init_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = np.sort(np.exp(rng.uniform(2.0, 18.0, 30)))
    logx = np.log(x + 1.0).astype(np.float32)
    y = np.cumsum(rng.exponential(1e-9, 30)).astype(np.float32)
    rng.shuffle(y[:5])
    for k in (1, 3, 4):
        got = p_models._sigmoid_init(logx, y, k)
        want = r_models._sigmoid_init(logx, y, k)
        assert set(got) == set(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])


def test_2d_sigmoids_bloom_model():
    """f(x, m) = S1(x) + (m-1) S2(x) — Table 1 'sum of sum of sigmoids'."""
    x = np.tile(np.logspace(2, 6, 20), 4)
    m_in = np.repeat([1, 2, 3, 4], 20)
    logx = np.log(x + 1.0)
    y = 1e-8 / (1 + np.exp(-(logx - 8.0))) * m_in
    port = p_models.fit2d_sigmoids(x, m_in, y)
    ref = r_models.fit2d_sigmoids(x, m_in, y)
    pred = p_models.predict2d(port, x, m_in)
    assert p_models.r2_score(y, pred) > 0.9
    assert port.kind == ref.kind == "sigmoids2d"
    assert port.x_range == ref.x_range
    want = r_models.predict2d(ref, x, m_in)
    assert np.max(np.abs(pred - want)) / np.max(y) <= FIT_ATOL
    # predict2d stays pure on a fitted model: m=1 is plain predict
    before = {k: v.copy() for k, v in port.params.items()}
    np.testing.assert_allclose(p_models.predict2d(port, x, np.ones_like(x)),
                               port.predict(x), rtol=1e-6)
    for k, v in port.params.items():
        np.testing.assert_array_equal(v, before[k])


def test_fitted_predictions_nonnegative_clipped_and_roundtrip():
    x = np.logspace(1, 4, 10)
    m = p_models.fit("linear", x, 1e-9 * x)
    assert float(m.predict(np.asarray([1e12]))[0]) <= \
        float(m.predict(np.asarray([x.max()]))[0]) * 1.001
    assert np.all(m.predict(x) >= 0.0)
    m = p_models.fit("log_linear", np.logspace(1, 5, 16),
                     2e-9 * np.logspace(1, 5, 16) + 1e-8 *
                     np.log(np.logspace(1, 5, 16)))
    m2 = r_models.FittedModel.from_json(m.to_json())   # the reference reads it
    x = np.logspace(1, 5, 16)
    np.testing.assert_allclose(m.predict(x), m2.predict(x), rtol=1e-6)


@pytest.mark.parametrize("case", ["sigmoids", "log_loglog"])
def test_recorded_fit_replays_exactly(case):
    """Recording a fit changes none of its bits, keeps every step's
    state and gradient, and a replay on the same device finds no gap."""
    kind, x, y, _ = RECOVERY[case]
    record = {}
    fitted = p_models.fit(kind, x, y, record=record)
    plain = p_models.fit(kind, x, y)
    for k, v in plain.params.items():
        np.testing.assert_array_equal(fitted.params[k], v)
    steps = 4000 if kind == "sigmoids" else 2000
    assert len(record["states"]) == steps + 1
    assert len(record["grads"]) == steps
    assert p_models.replay_gap(record, "cpu") == {"grad": 0.0, "update": 0.0}


@pytest.mark.parametrize("fault", ["gradient", "moment", "parameter"])
def test_replay_finds_a_wrong_step(fault):
    """One step computed wrongly shows in the replay, above
    ``chip_smoke.py``'s limits (gradient 1e-4 of the fit's largest
    entry, update 1e-5 of its terms): an early gradient off by a
    hundredth of its size, or late in the fit a first moment or a
    parameter off by a thousandth."""
    kind, x, y, _ = RECOVERY["sigmoids"]
    record = {}
    p_models.fit(kind, x, y, record=record)
    if fault == "gradient":
        g = record["grads"][10]
        record["grads"][10] = g + 0.01 * torch.abs(g).max()
    else:
        i = 3000
        p, m, v = record["states"][i + 1]
        if fault == "moment":
            m = m * 1.001
        else:
            p = p * 1.001
        record["states"][i + 1] = (p, m, v)
    gap = p_models.replay_gap(record, "cpu")
    if fault == "gradient":
        assert gap["grad"] > 1e-4, gap
    else:
        assert gap["update"] > 1e-5, gap


def test_fits_of_data_one_ulp_apart_replay_within_the_limit():
    """Rounding that differs from step to step (here: the same fit of
    data moved up by one float32 ulp, replayed against the unmoved
    data's loss) stays under the replay's gradient limit, though the two
    fits themselves drift apart."""
    kind, x, y, _ = RECOVERY["sigmoids"]
    y32 = y.astype(np.float32)
    base, moved = {}, {}
    p_models.fit(kind, x, y32, record=base)
    p_models.fit(kind, x, np.nextafter(y32, np.float32(np.inf)),
                 record=moved)
    gap = p_models.replay_gap(dict(moved, loss=base["loss"]), "cpu")
    assert gap["grad"] <= 1e-4 and gap["update"] == 0.0, gap


def test_fit_needs_a_device_choice(monkeypatch):
    """Without a CPU request the fitters run on CUDA, or raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(runtime, "_CHOSEN", None)
    with pytest.raises(runtime.NoDeviceError):
        p_models.fit("linear", _LINEAR_X, _LINEAR_X)
    with pytest.raises(runtime.NoDeviceError):
        p_models.fit("sigmoids", _LINEAR_X, _LINEAR_X)
    with pytest.raises(runtime.NoDeviceError):
        p_training.quick_profile()
    assert p_models.fit("linear", _LINEAR_X, _LINEAR_X,
                        device="cpu").kind == "linear"


# ---------------------------------------------------------------------------
# The training pass, on the same deterministic measurements in both
# ---------------------------------------------------------------------------
_ANALYTICAL = r_hw.hw1()


def _measurements(prim, sizes=None, reps=64):
    """Deterministic stand-in for a micro-benchmark: hw1's model of the
    primitive at each size, times 3% seeded noise (a seed per name)."""
    xs = np.asarray([float(n) for n in (sizes or prim.sizes)], np.float64)
    rng = np.random.default_rng(zlib.crc32(prim.name.encode()))
    y = _ANALYTICAL.models[prim.name].predict(xs).astype(np.float64)
    return xs, y * (1.0 + 0.03 * rng.standard_normal(len(xs)))


@pytest.fixture(scope="module")
def profiles():
    """(port, reference) profiles from train_profile and quick_profile."""
    with pytest.MonkeyPatch.context() as mp, runtime.use_device("cpu"):
        mp.setattr(r_training, "benchmark_primitive", _measurements)
        mp.setattr(p_training, "benchmark_primitive", _measurements)
        return {"train": (p_training.train_profile(),
                          r_training.train_profile()),
                "quick": (p_training.quick_profile(),
                          r_training.quick_profile())}


@pytest.mark.parametrize("which", ["train", "quick"])
def test_trained_profiles_match_reference(profiles, which):
    port, ref = profiles[which]
    assert sorted(port.models) == sorted(ref.models) == \
        sorted(r_access.LEVEL2)
    for name, prim in r_access.LEVEL2.items():
        sizes = prim.sizes[:5] if which == "quick" else prim.sizes
        x, y = _measurements(prim, sizes)
        assert port.models[name].kind == prim.model_kind
        _assert_fits_agree(port.models[name], ref.models[name], x, y, name)
    if which == "train":
        for name in r_access.LEVEL2:
            assert abs(port.constants[f"r2_{name}"]
                       - ref.constants[f"r2_{name}"]) <= R2_ATOL
            assert port.constants[f"fit_seconds_{name}"] > 0.0


def test_trained_profiles_cross_over_json(profiles, tmp_path):
    """A profile the port trained loads in the reference, and the reverse;
    every model predicts as before the round trip."""
    port, ref = profiles["train"]
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    in_ref = r_hw.HardwareProfile.load(str(tmp_path / "port.json"))
    in_port = p_hw.HardwareProfile.load(str(tmp_path / "ref.json"))
    x = np.logspace(0.5, 8.5, 50)
    for name in r_access.LEVEL2:
        np.testing.assert_allclose(in_ref.models[name].predict(x),
                                   port.models[name].predict(x), rtol=1e-6)
        np.testing.assert_allclose(in_port.models[name].predict(x),
                                   ref.models[name].predict(x), rtol=1e-6)
    assert in_ref.constants == port.constants


@pytest.mark.parametrize("mix", [{"get": 100.0},
                                 {"get": 50.0, "update": 50.0}])
def test_trained_profiles_choose_the_same_design(profiles, mix):
    """complete_design and design_beam choose the same design under the
    port's and the reference's profile.  Their costs are not compared
    across profiles: a cost sums predictions at small sizes too, where
    the fitted intercept (a jitter-sized number, see the module
    docstring) is most of the prediction — serial_write's intercept
    differs by 5% between the two fits here.  Each package's cost is
    held to its own scalar oracle instead."""
    port, ref = profiles["train"]
    w_p = p_syn.Workload(n_entries=1_000_000, n_queries=100)
    w_r = r_syn.Workload(n_entries=1_000_000, n_queries=100)
    got = p_ac.complete_design((), w_p, port, mix=mix, max_depth=2)
    want = r_ac.complete_design((), w_r, ref, mix=mix, max_depth=2)
    assert got.explored == want.explored
    assert got.spec.describe() == want.spec.describe(), \
        (got.spec.describe(), want.spec.describe())
    oracle = p_syn.cost_workload(got.spec, w_p, port, mix)
    assert abs(got.cost_seconds - oracle) / oracle <= 1e-6
    beam_p = p_ac.design_beam(w_p, port, mix, beam_width=4, max_rounds=6,
                              budget=p_search.SearchBudget(400))
    beam_r = r_ac.design_beam(w_r, ref, mix, beam_width=4, max_rounds=6,
                              budget=r_search.SearchBudget(400))
    assert beam_p["design"] == beam_r["design"], \
        (beam_p["design"], beam_r["design"])
    assert beam_p["designs_costed"] == beam_r["designs_costed"]


# ---------------------------------------------------------------------------
# The twin of tests/test_accuracy.py (Fig. 6): synthesized costs track the
# ground-truth structures
# ---------------------------------------------------------------------------
#: (spec name, ground-truth class name): the slow O(N)-scan structures
#: and the indexed ones must separate cleanly
PAIRS = [("array", "Array"), ("sorted_array", "SortedArray"),
         ("linked_list", "LinkedList"), ("skip_list", "SkipList"),
         ("hash_table", "HashTable"), ("btree", "BPlusTree")]
SLOW = {"array", "linked_list"}
FAST = {"sorted_array", "btree", "skip_list"}


def _predicted_gets(el_mod, syn_mod, hw, n):
    out = {}
    for name, _ in PAIRS:
        make = el_mod.ALL_PAPER_SPECS[name]
        spec = make(n) if "n_puts" in inspect.signature(make).parameters \
            else make()
        out[name] = syn_mod.cost("get", spec,
                                 syn_mod.Workload(n_entries=n, n_queries=200),
                                 hw)
    return out


def test_synthesized_ranking_matches_measured_and_reference(profiles):
    """The reference's test ranks predicted against *measured* latencies
    by rank correlation, which a busy CPU can upset.  Here the measured
    half keeps only the reference's slow-vs-fast separation (orders of
    magnitude apart), and the predicted half is held deterministically:
    under profiles trained from the same measurements, the port predicts
    the reference's exact ranking, with the scan-bound structures
    slowest."""
    port, ref = profiles["quick"]
    n = 50_000
    rng = np.random.default_rng(1234)
    keys = rng.choice(np.arange(n * 4), size=n, replace=False).astype(np.int64)
    values = rng.integers(0, 1 << 30, size=n).astype(np.int64)
    queries = keys[rng.integers(0, n, size=200)]
    measured = {name: S.measure_workload(getattr(S, cls)(), keys, values,
                                         queries)["per_query_s"]
                for name, cls in PAIRS}
    predicted = _predicted_gets(p_el, p_syn, port, n)
    reference = _predicted_gets(r_el, r_syn, ref, n)
    for s in SLOW:
        for f in FAST:
            assert predicted[s] > predicted[f], (s, f, predicted)
            assert measured[s] > measured[f], (s, f, measured)
    names = [name for name, _ in PAIRS]
    assert sorted(names, key=predicted.get) == \
        sorted(names, key=reference.get), (predicted, reference)


def test_synthesized_cost_grows_with_data(profiles):
    """Fig. 6 x-axis: latency grows as data grows from 1e5 to 1e7."""
    port, _ = profiles["quick"]
    costs = [p_syn.cost("get", p_el.spec_btree(), p_syn.Workload(n_entries=n),
                        port) for n in (10**5, 10**6, 10**7)]
    assert costs[0] < costs[2]
