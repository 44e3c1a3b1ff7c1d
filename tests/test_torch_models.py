"""Port vs reference: Level-2 cost-model evaluation and hardware profiles.

The same parameters (drawn with numpy from a seed) go into the
reference's ``repro.core.models.FittedModel`` and the port's
``repro_torch.core.models.FittedModel``; predictions must agree to
rtol 1e-6.  Sizes are drawn at random, so no query sits exactly midway
between two knn support points (the two top-k implementations may order
exact ties differently).

Why 1e-6 holds only where the model is well conditioned: XLA's float32
``log``/``exp`` on the CPU are off the correctly rounded value by an ulp
on ~1.6% / ~9.5% of inputs, torch's on ~0.003% / ~1%.  A steep sigmoid
(``k (ln x - x0)``) or a knn query next to a support point (weight
``1 / (d + 1e-6)``) magnifies a one-ulp difference in ``ln x`` past 1e-6
relative, and a knn weight's distance ``|ln x - ln x_i|`` carries the
float32 rounding of two logs.  :func:`assert_parity` therefore holds each
prediction to rtol 1e-6, and where the two differ by more it requires
the port to lie within float32's own reach of the model evaluated in
float64: 1e-6 relative plus what a two-ulp change of ``ln(x + 1)``
moves the float64 value by — and such points to stay rare.
"""
import numpy as np
import pytest

from repro.core import hardware as r_hw
from repro.core import models as r_models
from repro_torch import runtime
from repro_torch.core import hardware as p_hw
from repro_torch.core import models as p_models

RTOL = 1e-6
#: at most this share of predictions may fall back to the float64 check
MAX_ILL_CONDITIONED = 0.02


def _exact(model, x, dlx=0.0) -> np.ndarray:
    """The model evaluated in float64 from the float32 inputs both
    packages see (``x`` clipped and ``x + 1`` rounded in float32), with
    ``ln(x + 1)`` shifted by ``dlx``."""
    p = {k: np.asarray(v, np.float64) for k, v in model.params.items()}
    x32 = np.clip(np.atleast_1d(np.asarray(x, np.float32)),
                  model.x_range[0], model.x_range[1])
    xd = x32.astype(np.float64)
    lx = np.log((x32 + np.float32(1.0)).astype(np.float64)) + dlx

    def sig(prefix=""):
        z = p[prefix + "k"][None, :] * (lx[:, None] - p[prefix + "x0"][None])
        return (p[prefix + "c"][None] / (1.0 + np.exp(-z))).sum(1) + \
            p[prefix + "y0"]

    kind = model.kind
    if kind == "linear":
        y = xd * p["w"][0] + p["y0"]
    elif kind == "log_linear":
        y = xd * p["w"][0] + lx * p["w"][1] + p["y0"]
    elif kind == "log_loglog":
        y = xd * p["w"][0] + lx * p["w"][1] + np.log(lx + 1.0) * p["w"][2] \
            + p["y0"]
    elif kind == "nlogn":
        y = xd * lx * p["w"][0] + xd * p["w"][1] + p["y0"]
    elif kind == "sigmoids":
        y = sig()
    elif kind == "sigmoids2d":
        y = sig("s1_")
    elif kind == "knn":
        xs32 = np.asarray(model.params["x"], np.float32)
        lxs = np.log((xs32 + np.float32(1.0)).astype(np.float64))
        w = 1.0 / (np.abs(lx[:, None] - lxs[None]) + 1e-6)
        top = np.argsort(-w, axis=1, kind="stable")[:, :4]
        wk = np.take_along_axis(w, top, 1)
        y = (wk * p["y"][top]).sum(1) / wk.sum(1)
    else:
        raise KeyError(kind)
    return np.maximum(y, 0.0)


def assert_parity(model, x, port_y, ref_y, what=""):
    """rtol 1e-6 port vs reference, or (rarely) within float32's reach of
    the float64 value — see the module docstring."""
    port_y, ref_y = np.asarray(port_y, np.float64), np.asarray(ref_y,
                                                                np.float64)
    loose = np.abs(port_y - ref_y) > RTOL * np.abs(ref_y)
    assert loose.mean() <= MAX_ILL_CONDITIONED, \
        f"{what}: {loose.sum()} of {loose.size} predictions differ > 1e-6"
    if loose.any():
        xl = np.asarray(x)[loose]
        exact = _exact(model, xl)
        lx = np.log(np.float32(np.clip(xl, *model.x_range)) + 1.0)
        if model.kind == "knn":      # the support's logs round too
            lx = np.maximum(lx, np.log(np.float32(model.params["x"].max())
                                       + 1.0))
        u = 2.0 * np.spacing(np.float32(lx)).astype(np.float64)
        reach = np.maximum(np.abs(_exact(model, xl, u) - exact),
                           np.abs(_exact(model, xl, -u) - exact))
        err = np.abs(port_y[loose] - exact)
        assert (err <= RTOL * exact + reach).all(), \
            f"{what}: the port is beyond float32's reach of float64"


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _params(kind: str, rng) -> dict:
    if kind in ("linear", "log_linear", "log_loglog", "nlogn"):
        n = {"linear": 1, "log_linear": 2, "log_loglog": 3, "nlogn": 2}[kind]
        return {"w": rng.uniform(1e-10, 1e-8, n).astype(np.float32),
                "y0": np.asarray(rng.uniform(1e-9, 1e-8), np.float32)}
    if kind == "sigmoids":
        return {"c": rng.uniform(1e-9, 1e-7, 3).astype(np.float32),
                "k": rng.uniform(0.5, 8.0, 3).astype(np.float32),
                "x0": np.sort(rng.uniform(2.0, 18.0, 3)).astype(np.float32),
                "y0": np.asarray(1e-9, np.float32)}
    if kind == "sigmoids2d":
        p = {}
        for part in ("s1_", "s2_"):
            p.update({part + k: v for k, v in
                      _params("sigmoids", rng).items()})
        return p
    raise KeyError(kind)


def _pair(kind, params, x_range=(1.0, 1e9)):
    return (r_models.FittedModel(kind, dict(params), x_range),
            p_models.FittedModel(kind, dict(params), x_range))


@pytest.mark.parametrize("kind", ["linear", "log_linear", "log_loglog",
                                  "nlogn", "sigmoids", "sigmoids2d"])
def test_parametric_predict_matches_reference(kind):
    rng = np.random.default_rng(11)
    ref, port = _pair(kind, _params(kind, rng))
    x = np.exp(rng.uniform(0.0, 22.0, 300))
    assert_parity(port, x, port.predict(x), ref.predict(x), kind)


@pytest.mark.parametrize("n_points", [12, 4, 3, 1])
def test_knn_predict_matches_reference(n_points):
    rng = np.random.default_rng(n_points)
    xs = np.sort(np.exp(rng.uniform(1.0, 14.0, n_points))).astype(np.float32)
    ys = (2e-9 * xs * np.log(xs) + 1e-8).astype(np.float32)
    ref, port = _pair("knn", {"x": xs, "y": ys},
                      (float(xs.min()), float(xs.max())))
    x = np.exp(rng.uniform(0.0, 16.0, 257))
    if n_points < 4:    # both packages take the same numpy path
        np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    else:
        assert_parity(port, x, port.predict(x), ref.predict(x))


def test_predict2d_matches_reference():
    rng = np.random.default_rng(3)
    params = _params("sigmoids2d", rng)
    ref, port = _pair("sigmoids2d", params)
    x = np.exp(rng.uniform(0.0, 20.0, 64))
    m = rng.integers(1, 9, 64)
    np.testing.assert_allclose(p_models.predict2d(port, x, m),
                               r_models.predict2d(ref, x, m), rtol=RTOL)
    with pytest.raises(ValueError):
        p_models.predict2d(_pair("linear", _params("linear", rng))[1], x, m)


@pytest.mark.parametrize("kind", ["log_loglog", "sigmoids", "knn"])
def test_predict_is_position_independent(kind):
    """A size costs the same alone (the scalar oracle) as inside a batch
    (the grouped engine): the port's 1e-9 scalar/grouped contract."""
    rng = np.random.default_rng(5)
    if kind == "knn":
        xs = np.sort(np.exp(rng.uniform(1.0, 14.0, 9))).astype(np.float32)
        params, x_range = {"x": xs, "y": xs * 1e-9}, (1.0, 1e7)
    else:
        params, x_range = _params(kind, rng), (1.0, 1e9)
    model = p_models.FittedModel(kind, params, x_range)
    x = np.exp(rng.uniform(0.0, 21.0, 1000))
    batch = model.predict(x)
    alone = np.asarray([model.predict_scalar(v) for v in x[:200]])
    np.testing.assert_array_equal(batch[:200], alone.astype(batch.dtype))


def test_json_roundtrip_and_helpers():
    rng = np.random.default_rng(9)
    ref, port = _pair("sigmoids", _params("sigmoids", rng), (2.0, 1e8))
    back = p_models.FittedModel.from_json(ref.to_json())
    assert back.to_json() == ref.to_json() == port.to_json()
    assert p_models.KNN_SENTINEL == r_models.KNN_SENTINEL
    assert set(p_models._BASES) == set(r_models._BASES)
    y, yp = rng.uniform(size=50), rng.uniform(size=50)
    assert p_models.r2_score(y, yp) == r_models.r2_score(y, yp)


@pytest.mark.parametrize("route", ["json", "arrays"])
def test_trained_profile_crosses_over(cpu_profile, tmp_path, route):
    """A profile the reference trained (quick_profile) reaches the port
    through its JSON file or as numpy arrays; every model predicts the
    same sizes to rtol 1e-6."""
    if route == "json":
        path = str(tmp_path / "quick.json")
        cpu_profile.save(path)
        port = p_hw.HardwareProfile.load(path)
    else:
        port = p_hw.profile_from_arrays(cpu_profile.name, {
            name: (m.kind, {k: np.asarray(v) for k, v in m.params.items()},
                   m.x_range)
            for name, m in cpu_profile.models.items()})
    assert set(port.models) == set(cpu_profile.models)
    x = np.exp(np.random.default_rng(2).uniform(0.0, 20.0, 200))
    for name, ref_model in cpu_profile.models.items():
        assert_parity(port.model(name), x, port.model(name).predict(x),
                      ref_model.predict(x), name)


@pytest.mark.parametrize("make", ["hw1", "hw2", "hw3"])
def test_analytical_profiles_match(make, tmp_path):
    ref, port = getattr(r_hw, make)(), getattr(p_hw, make)()
    assert ref.name == port.name and ref.constants == port.constants
    x = np.exp(np.random.default_rng(4).uniform(0.0, 25.0, 100))
    for name, m in ref.models.items():
        assert_parity(port.model(name), x, port.model(name).predict(x),
                      m.predict(x), name)
    path = str(tmp_path / "p.json")
    port.save(path)
    again = r_hw.HardwareProfile.load(path)     # same schema both ways
    assert {k: m.to_json() for k, m in again.models.items()} == \
        {k: m.to_json() for k, m in port.models.items()}
