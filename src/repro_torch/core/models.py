"""Learned cost models for Level-2 access primitives: evaluation in torch.

The port's twin of the reference's ``core/models.py`` model zoo (Table 1):
Linear, Log-Linear, Log+LogLog, NLogN, Sum-of-Sigmoids,
Sum-of-Sum-of-Sigmoids (2-D, evaluated as its m=1 slice by ``predict``)
and Weighted k-NN.  Fitted parameters are numpy float32 arrays, whether
they come from :func:`fit` / :func:`fit2d_sigmoids`, from the profile
JSON that both packages share (:meth:`FittedModel.from_json`) or from
:func:`repro_torch.core.hardware.profile_from_arrays`.

Fitting runs in torch on the runtime device: the linear-basis family by
non-negative least squares (a ridge warm start, then 2,000 steps of
projected Adam), the sigmoid family by 4,000 Adam steps from the paper's
rate-of-change initialization.  Every loop keeps its state on the device
and reads nothing back until it ends; its constants (the bias
corrections, the learning rates) are float32, as in the reference's
``lax.scan`` over a float32 step index.

Prediction runs in float32 on the runtime device
(:func:`repro_torch.runtime.device`).  Every reduction over a parameter
axis is written out as a sequence of elementwise multiply-adds, never a
``matmul`` or ``torch.sigmoid``: on the CPU those two take a vectorized
path for most elements and a scalar path for the tail, which round
differently, so one size would cost differently depending on where it
sits in the batch.  Written out elementwise, a record's prediction is the
same whether it is scored alone (the scalar oracle) or inside a grouped
batch, which is what keeps the scalar/grouped 1e-9 contract exact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import runtime

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Linear-basis family: f(x) = w . phi(x) + y0 with w >= 0
# ---------------------------------------------------------------------------
def _basis_linear(x: torch.Tensor) -> List[torch.Tensor]:
    return [x]


def _basis_loglinear(x: torch.Tensor) -> List[torch.Tensor]:
    return [x, torch.log(x + 1.0)]


def _basis_logloglog(x: torch.Tensor) -> List[torch.Tensor]:
    lx = torch.log(x + 1.0)
    return [x, lx, torch.log(lx + 1.0)]


def _basis_nlogn(x: torch.Tensor) -> List[torch.Tensor]:
    return [x * torch.log(x + 1.0), x]


#: basis name -> the list of feature columns phi(x)
_BASES: Dict[str, Callable[[torch.Tensor], List[torch.Tensor]]] = {
    "linear": _basis_linear,
    "log_linear": _basis_loglinear,
    "log_loglog": _basis_logloglog,
    "nlogn": _basis_nlogn,
}


def _dot_columns(cols: List[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """sum_j cols[j] * w[j], accumulated left to right, elementwise."""
    acc = cols[0] * w[0]
    for j in range(1, len(cols)):
        acc = acc + cols[j] * w[j]
    return acc


def _predict_basis(w: torch.Tensor, y0: torch.Tensor, x: torch.Tensor,
                   basis: str) -> torch.Tensor:
    return _dot_columns(_BASES[basis](x), w) + y0


# ---------------------------------------------------------------------------
# Sum of sigmoids: f(x) = sum_i c_i / (1 + exp(-k_i (log x - x_i))) + y0
# ---------------------------------------------------------------------------
def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-z))


def _sigmoid_predict(params: Dict[str, torch.Tensor],
                     logx: torch.Tensor) -> torch.Tensor:
    c, k, x0 = params["c"], params["k"], params["x0"]
    acc = None
    for i in range(c.shape[0]):
        term = _sigmoid(k[i] * (logx - x0[i])) * c[i]
        acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(logx)
    return acc + params["y0"]


# ---------------------------------------------------------------------------
# Weighted k-NN (log-space) with a fixed k=4 top-k
# ---------------------------------------------------------------------------
#: log-space marker for padded k-NN bank slots (device tables pad every
#: model's support to a common width; slots at/beyond this distance carry
#: zero weight, so a model with n real points reduces to k = min(4, n))
KNN_SENTINEL = 1e9


def _knn_predict(lxs: torch.Tensor, ys: torch.Tensor,
                 lx: torch.Tensor) -> torch.Tensor:
    """Inverse-log-distance weighted 4-NN.

    ``topk`` runs over the *weights* (monotone in -distance), so padded
    sentinel slots — weight exactly 0 — can win a top-4 slot only when
    fewer than 4 real neighbors exist, in which case they contribute 0 to
    both the numerator and the denominator.  Exact ties between distinct
    support points may be ordered differently than the reference's
    ``lax.top_k``; the sum then differs only if the tied points' y do.
    """
    d = torch.abs(lx[:, None] - lxs[None, :]) + 1e-6
    w = torch.where(lxs[None, :] >= KNN_SENTINEL * 0.5,
                    torch.zeros_like(d), 1.0 / d)
    wk, idx = torch.topk(w, 4, dim=1)
    yk = ys[idx]
    num = wk[:, 0] * yk[:, 0]
    den = wk[:, 0]
    for j in range(1, 4):
        num = num + wk[:, j] * yk[:, j]
        den = den + wk[:, j]
    return num / torch.clamp(den, min=1e-30)


# ---------------------------------------------------------------------------
# Fitted model wrapper
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FittedModel:
    """A trained Level-2 cost model: latency_seconds = predict(x).

    ``predict`` is vectorized over x; the grouped engine of
    :mod:`repro_torch.core.batchcost` evaluates every record of a whole
    frontier in one call per Level-2 model.  Parameter tensors are built
    once per device and cached.
    """

    kind: str                       # linear|log_linear|log_loglog|nlogn|sigmoids|sigmoids2d|knn
    params: Dict[str, np.ndarray]
    x_range: Tuple[float, float] = (1.0, 1e9)
    _device_params: Dict[torch.device, Dict[str, torch.Tensor]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)

    def _tensors(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        dp = self._device_params.get(dev)
        if dp is None:
            dp = {k: torch.tensor(np.asarray(v, np.float32), device=dev)
                  for k, v in self.params.items()}
            if self.kind == "knn":
                dp["_logx"] = torch.log(dp["x"] + 1.0)
            self._device_params[dev] = dp
        return dp

    def predict(self, x, device: Optional[runtime.DeviceLike] = None
                ) -> np.ndarray:
        x = np.atleast_1d(np.asarray(x, dtype=np.float32))
        x = np.clip(x, self.x_range[0], self.x_range[1])
        if self.kind == "knn" and len(self.params["x"]) < 4:
            # numpy path: fewer support points than the fixed top-k
            xs = self.params["x"]
            ys = self.params["y"]
            lx = np.log(x + 1.0)
            lxs = np.log(xs + 1.0)
            d = np.abs(lx[:, None] - lxs[None, :]) + 1e-6
            k = min(4, len(xs))
            idx = np.argpartition(d, k - 1, axis=1)[:, :k]
            dk = np.take_along_axis(d, idx, axis=1)
            wk = 1.0 / dk
            out = (wk * ys[idx]).sum(axis=1) / wk.sum(axis=1)
            return np.maximum(np.asarray(out), 0.0)
        dev = runtime.device(device)
        p = self._tensors(dev)
        xt = torch.as_tensor(x, device=dev)
        if self.kind in _BASES:
            out = _predict_basis(p["w"], p["y0"], xt, self.kind)
        elif self.kind == "sigmoids":
            out = _sigmoid_predict(p, torch.log(xt + 1.0))
        elif self.kind == "sigmoids2d":
            # f(x, m) = S1(x) + (m - 1) * S2(x); plain predict is the m=1
            # slice, S1(x) (the m axis enters only through predict2d)
            out = _sigmoid_predict(
                {k: p["s1_" + k] for k in ("c", "k", "x0", "y0")},
                torch.log(xt + 1.0))
        elif self.kind == "knn":
            out = _knn_predict(p["_logx"], p["y"], torch.log(xt + 1.0))
        else:
            raise ValueError(self.kind)
        return np.maximum(out.cpu().numpy(), 0.0)

    def predict_scalar(self, x: float) -> float:
        return float(self.predict(np.asarray([x]))[0])

    def to_json(self) -> Dict:
        return {"kind": self.kind, "x_range": list(self.x_range),
                "params": {k: np.asarray(v).tolist()
                           for k, v in self.params.items()}}

    @staticmethod
    def from_json(obj: Dict) -> "FittedModel":
        return FittedModel(
            kind=obj["kind"],
            params={k: np.asarray(v, dtype=np.float32)
                    for k, v in obj["params"].items()},
            x_range=tuple(obj["x_range"]))


def predict2d(model: FittedModel, x, m,
              device: Optional[runtime.DeviceLike] = None) -> np.ndarray:
    """f(x, m) = S1(x) + (m - 1) S2(x), pure in (model, x, m)."""
    if model.kind != "sigmoids2d":
        raise ValueError(f"predict2d needs a sigmoids2d model, "
                         f"not {model.kind!r}")
    x = np.atleast_1d(np.asarray(x, dtype=np.float32))
    x = np.clip(x, model.x_range[0], model.x_range[1])
    m = np.atleast_1d(np.asarray(m, dtype=np.float32))
    dev = runtime.device(device)
    p = model._tensors(dev)
    logx = torch.log(torch.as_tensor(x, device=dev) + 1.0)
    s1 = _sigmoid_predict(
        {k: p["s1_" + k] for k in ("c", "k", "x0", "y0")}, logx)
    s2 = _sigmoid_predict(
        {k: p["s2_" + k] for k in ("c", "k", "x0", "y0")}, logx)
    out = s1 + (torch.as_tensor(m, device=dev) - 1.0) * s2
    return np.maximum(out.cpu().numpy(), 0.0)


# ---------------------------------------------------------------------------
# Fitting: projected Adam on the device
# ---------------------------------------------------------------------------
def _bias_corrections(steps: int, dev: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``1 - 0.9 ** t`` and ``1 - 0.999 ** t`` for t = 1..steps, float32
    (the reference computes them from a float32 step index)."""
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    b1 = torch.tensor(0.9, dtype=torch.float32, device=dev)
    b2 = torch.tensor(0.999, dtype=torch.float32, device=dev)
    return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


def _adam(loss_fn: Callable[[torch.Tensor], torch.Tensor],
          params: torch.Tensor, lower: torch.Tensor, lr: float,
          steps: int) -> torch.Tensor:
    """``steps`` of Adam on the flat float32 vector ``params``, each
    followed by ``max(params, lower)`` (the projection), with no host
    sync.  The update is the reference's term for term:
    ``p - lr * (m / bc1) / (sqrt(v / bc2) + 1e-8)``."""
    bc1, bc2 = _bias_corrections(steps, params.device)
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    p = params.detach()
    for i in range(steps):
        p = p.requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(p), p)
        with torch.no_grad():
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            p = torch.maximum(
                p - lr * (m / bc1[i]) / (torch.sqrt(v / bc2[i]) + 1e-8),
                lower)
    return p.detach()


def _fit_nnls(x: torch.Tensor, y: torch.Tensor, basis: str,
              steps: int = 2000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-negative least squares via projected Adam, ridge warm start.

    ``w`` and ``y0`` travel as one vector ``[w..., y0]``, both projected
    onto >= 0, so an Adam step is a handful of launches."""
    phi = torch.stack(_BASES[basis](x), dim=-1)
    scale = torch.clamp(torch.amax(torch.abs(phi), dim=0), min=_EPS)
    yscale = torch.clamp(torch.amax(torch.abs(y)), min=_EPS)
    phi_n, y_n = phi / scale, y / yscale
    n_w = phi.shape[-1]

    # ridge warm start (may have negative entries -> projected)
    a = phi_n.T @ phi_n + 1e-6 * torch.eye(n_w, dtype=phi.dtype,
                                            device=phi.device)
    b = phi_n.T @ y_n
    w = torch.clamp(torch.linalg.solve_ex(a, b)[0], min=0.0)
    y0 = torch.clamp(torch.mean(y_n - phi_n @ w), min=0.0)

    def loss_fn(p: torch.Tensor) -> torch.Tensor:
        r = phi_n @ p[:n_w] + p[n_w] - y_n
        return torch.mean(r * r)

    p = _adam(loss_fn, torch.cat([w, y0[None]]),
              torch.zeros(n_w + 1, dtype=torch.float32, device=x.device),
              3e-3, steps)
    return p[:n_w] * (yscale / scale), p[n_w] * yscale


def _sigmoid_init(logx: np.ndarray, y: np.ndarray, k: int) -> Dict[str, np.ndarray]:
    """Paper's initialization: local maxima of the rate of change -> x_i."""
    order = np.argsort(logx)
    lx, ys = logx[order], y[order]
    dy = np.diff(ys) / np.maximum(np.diff(lx), _EPS)
    # local maxima of |rate of change|
    mag = np.abs(dy)
    idx = np.argsort(mag)[::-1]
    centers = []
    for i in idx:
        x_candidate = 0.5 * (lx[i] + lx[i + 1])
        if all(abs(x_candidate - c) > 0.5 for c in centers):
            centers.append(float(x_candidate))
        if len(centers) == k:
            break
    while len(centers) < k:
        centers.append(float(np.median(lx)))
    rng = np.random.default_rng(0)
    return {
        "c": rng.uniform(0.1, 1.0, size=k).astype(np.float32)
             * max(float(ys.max() - ys.min()), _EPS) / k,
        "k": rng.uniform(0.5, 1.0, size=k).astype(np.float32) * 4.0,
        "x0": np.asarray(sorted(centers), dtype=np.float32),
        "y0": np.asarray(float(ys[0]), dtype=np.float32),
    }


def _fit_sigmoids_gd(logx: torch.Tensor, y: torch.Tensor,
                     init: Dict[str, torch.Tensor],
                     steps: int = 4000) -> Dict[str, torch.Tensor]:
    """Adam on ``sum_i c_i sigmoid(k_i (logx - x0_i)) + y0`` against the
    standardized ``y``; amplitudes stay >= 0 and slopes >= 1e-3
    (monotone step functions).  The parameters travel as one vector
    ``[c, k, x0, y0]``."""
    yscale = torch.clamp(torch.amax(torch.abs(y)), min=_EPS)
    y_n = y / yscale
    k = init["c"].shape[0]
    flat = torch.cat([init["c"] / yscale, init["k"], init["x0"],
                      (init["y0"] / yscale).reshape(1)])
    lower = torch.full_like(flat, -float("inf"))
    lower[:k] = 0.0
    lower[k:2 * k] = 1e-3

    def loss_fn(p: torch.Tensor) -> torch.Tensor:
        z = torch.sigmoid(p[k:2 * k][None, :] *
                          (logx[:, None] - p[2 * k:3 * k][None, :]))
        pred = z @ p[:k] + p[3 * k]
        return torch.mean((pred - y_n) ** 2)

    p = _adam(loss_fn, flat, lower, 2e-2, steps)
    return {"c": p[:k] * yscale, "k": p[k:2 * k], "x0": p[2 * k:3 * k],
            "y0": p[3 * k] * yscale}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def fit(kind: str, x: np.ndarray, y: np.ndarray, num_sigmoids: int = 3,
        device: Optional[runtime.DeviceLike] = None) -> FittedModel:
    """Fit one cost model of the given kind to benchmark data (x, y).

    The loops run on ``device`` (the runtime device by default); the
    returned parameters are numpy float32, as the reference's."""
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    x_range = (float(x.min()), float(x.max()))
    if kind in _BASES:
        dev = runtime.device(device)
        w, y0 = _fit_nnls(torch.as_tensor(x, device=dev),
                          torch.as_tensor(y, device=dev), kind)
        return FittedModel(kind, {"w": _numpy(w), "y0": _numpy(y0)},
                           x_range)
    if kind == "sigmoids":
        dev = runtime.device(device)
        logx = np.log(x + 1.0)
        init = _sigmoid_init(logx, y, num_sigmoids)
        params = _fit_sigmoids_gd(
            torch.as_tensor(logx, device=dev), torch.as_tensor(y, device=dev),
            {k: torch.as_tensor(v, device=dev) for k, v in init.items()})
        return FittedModel(kind, {k: _numpy(v) for k, v in params.items()},
                           x_range)
    if kind == "knn":
        return FittedModel(kind, {"x": x, "y": y}, x_range)
    raise ValueError(kind)


def fit2d_sigmoids(x: np.ndarray, m: np.ndarray, y: np.ndarray,
                   num_sigmoids: int = 3,
                   device: Optional[runtime.DeviceLike] = None
                   ) -> FittedModel:
    """Sum-of-sum-of-sigmoids: f(x, m) = S1(x) + (m-1) S2(x) (bloom filters)."""
    x = np.asarray(x, dtype=np.float32)
    m = np.asarray(m, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    # fit S1 on the m == min(m) slice, then S2 on the residual slope wrt m
    m0 = float(m.min())
    base_mask = m == m0
    s1 = fit("sigmoids", x[base_mask], y[base_mask] / max(m0, 1.0),
             num_sigmoids=num_sigmoids, device=device)
    resid_mask = m > m0
    if resid_mask.any():
        slope = (y[resid_mask] - s1.predict(x[resid_mask], device) * 1.0) / \
            np.maximum(m[resid_mask] - 1.0, 1.0)
        s2 = fit("sigmoids", x[resid_mask], np.maximum(slope, 0.0),
                 num_sigmoids=num_sigmoids, device=device)
    else:
        s2 = FittedModel("sigmoids", {
            "c": np.zeros(num_sigmoids, np.float32),
            "k": np.ones(num_sigmoids, np.float32),
            "x0": np.zeros(num_sigmoids, np.float32),
            "y0": np.zeros((), np.float32)})
    params = {}
    for key in ("c", "k", "x0", "y0"):
        params["s1_" + key] = s1.params[key]
        params["s2_" + key] = s2.params[key]
    return FittedModel("sigmoids2d", params,
                       (float(x.min()), float(x.max())))


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum()) + _EPS
    return 1.0 - ss_res / ss_tot
