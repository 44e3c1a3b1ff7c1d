"""Port vs reference: the state-space and recurrent blocks
(``models/ssm.py``) on the CPU.

The reference runs them as jitted XLA without a Pallas kernel; the port
as plain torch.  The same numpy-seeded inputs and the reference's own
``init_*`` weights go through both in float32: outputs and states to
1e-5 (float32 sums in another order).  Sequence lengths are not
multiples of the scan's chunk, so the padding path runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_get_smoke
from repro.models import ssm as r_ssm
from repro_torch import runtime
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm as p_ssm

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with runtime.use_device("cpu"):
        yield


def _cfgs(arch, **changes):
    changes = dict(compute_dtype="float32", **changes)
    return (dataclasses.replace(r_get_smoke(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], **tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _scan_inputs(rng, b, s, h, p, n):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B = rng.standard_normal((b, s, h, n)).astype(np.float32)
    C = rng.standard_normal((b, s, h, n)).astype(np.float32)
    loga = -np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
        np.float32)
    return x, B, C, loga


@pytest.mark.parametrize("s,chunk,with_h0", [(37, 16, False), (64, 16, True),
                                             (5, 16, False), (40, 40, True)])
def test_chunked_linear_scan_matches_reference(s, chunk, with_h0):
    rng = np.random.default_rng(s + chunk)
    x, B, C, loga = _scan_inputs(rng, 2, s, 3, 8, 4)
    h0 = rng.standard_normal((2, 3, 4, 8)).astype(np.float32) \
        if with_h0 else None
    want_y, want_h = r_ssm.chunked_linear_scan(
        *map(jnp.asarray, (x, B, C, loga)), chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = p_ssm.chunked_linear_scan(
        *map(torch.as_tensor, (x, B, C, loga)), chunk,
        h0=None if h0 is None else torch.as_tensor(h0))
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_linear_scan_step_matches_reference_and_the_chunked_scan():
    """One step against the reference's; the steps in a row against the
    port's own chunked scan (the decode path against the prefill path)."""
    rng = np.random.default_rng(5)
    x, B, C, loga = _scan_inputs(rng, 2, 21, 3, 8, 4)
    h = np.zeros((2, 3, 4, 8), np.float32)
    hp = torch.zeros((2, 3, 4, 8))
    ys = []
    for t in range(x.shape[1]):
        args = (x[:, t], B[:, t], C[:, t], loga[:, t])
        h, want_y = r_ssm.linear_scan_step(jnp.asarray(h),
                                           *map(jnp.asarray, args))
        hp, got_y = p_ssm.linear_scan_step(hp, *map(torch.as_tensor, args))
        _close(got_y, want_y)
        _close(hp, h)
        ys.append(got_y)
    y, h_final = p_ssm.chunked_linear_scan(
        *map(torch.as_tensor, (x, B, C, loga)), 8)
    _close(torch.stack(ys, dim=1), y.numpy(), rtol=1e-4, atol=1e-4)
    _close(hp, h_final.numpy(), rtol=1e-4, atol=1e-4)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for st in (None, state):
        want = r_ssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                                  None if st is None else jnp.asarray(st))
        got = p_ssm._causal_conv(*map(torch.as_tensor, (x, w, b)),
                                 None if st is None else torch.as_tensor(st))
        _close(got[0], want[0])
        _close(got[1], want[1])


def _block_io(cfg_r, init_r, seed, s):
    params = jax.tree.map(np.asarray, init_r(jax.random.PRNGKey(seed), cfg_r))
    x = np.random.default_rng(seed).standard_normal(
        (2, s, cfg_r.d_model)).astype(np.float32)
    return params, _torch(params), x


def _check_block(forward_r, forward_p, step_r, step_p, init_state_r,
                 init_state_p, params_r, params_p, x, cfg_r, cfg_p):
    """Forward over x, then the same positions one step at a time with
    the state carried, each against the reference."""
    forward_r = jax.jit(forward_r, static_argnums=2)
    step_r = jax.jit(step_r, static_argnums=3)
    _close(forward_p(params_p, torch.as_tensor(x), cfg_p),
           forward_r(params_r, jnp.asarray(x), cfg_r))
    state_r = init_state_r(cfg_r, x.shape[0])
    state_p = init_state_p(cfg_p, x.shape[0], device="cpu")
    for t in range(x.shape[1]):
        y_r, state_r = step_r(params_r, jnp.asarray(x[:, t:t + 1]), state_r,
                              cfg_r)
        y_p, state_p = step_p(params_p, torch.as_tensor(x[:, t:t + 1]),
                              state_p, cfg_p)
        _close(y_p, y_r)
        _close(state_p, state_r)


def test_mamba2_forward_and_step_match_reference():
    cfg_r, cfg_p = _cfgs("zamba2-1.2b", ssm_chunk=8)
    params_r, params_p, x = _block_io(cfg_r, r_ssm.init_mamba2, 1, 19)
    assert p_ssm.mamba2_dims(cfg_p) == r_ssm.mamba2_dims(cfg_r)
    # non-trivial decay, skip and dt bias
    rng = np.random.default_rng(1)
    for name in ("A_log", "dt_bias", "D_skip"):
        params_r[name] = rng.standard_normal(params_r[name].shape).astype(
            np.float32)
        params_p[name] = torch.tensor(params_r[name])
    _check_block(r_ssm.mamba2_forward, p_ssm.mamba2_forward,
                 r_ssm.mamba2_step, p_ssm.mamba2_step,
                 r_ssm.mamba2_init_state, p_ssm.mamba2_init_state,
                 params_r, params_p, x, cfg_r, cfg_p)


def test_mlstm_forward_and_step_match_reference():
    cfg_r, cfg_p = _cfgs("xlstm-350m", ssm_chunk=8)
    params_r, params_p, x = _block_io(cfg_r, r_ssm.init_mlstm, 2, 13)
    _check_block(r_ssm.mlstm_forward, p_ssm.mlstm_forward,
                 r_ssm.mlstm_step, p_ssm.mlstm_step,
                 r_ssm.mlstm_init_state, p_ssm.mlstm_init_state,
                 params_r, params_p, x, cfg_r, cfg_p)


def test_slstm_forward_and_step_match_reference():
    cfg_r, cfg_p = _cfgs("xlstm-350m")
    params_r, params_p, x = _block_io(cfg_r, r_ssm.init_slstm, 3, 11)
    rng = np.random.default_rng(3)
    params_r["bias"] = rng.standard_normal(params_r["bias"].shape).astype(
        np.float32)
    params_p["bias"] = torch.tensor(params_r["bias"])
    _check_block(r_ssm.slstm_forward, p_ssm.slstm_forward,
                 r_ssm.slstm_step, p_ssm.slstm_step,
                 r_ssm.slstm_init_state, p_ssm.slstm_init_state,
                 params_r, params_p, x, cfg_r, cfg_p)


@pytest.mark.parametrize("init", ["mamba2", "mlstm", "slstm"])
def test_init_shapes_and_dtypes_match_reference(init):
    arch = "zamba2-1.2b" if init == "mamba2" else "xlstm-350m"
    cfg_r, cfg_p = _cfgs(arch)
    want = getattr(r_ssm, f"init_{init}")(jax.random.PRNGKey(0), cfg_r)
    got = getattr(p_ssm, f"init_{init}")(torch.Generator().manual_seed(0),
                                         cfg_p, "cpu")
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
