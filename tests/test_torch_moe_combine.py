"""The MoE combine as a gather (``kernels/moe_combine``) on the CPU.

Its plain version (``ref.py``: each token sums the rows of the slots that
took it, in float32, in the order of its top-k list) against ``moe_ffn``'s
scatter-add combine (``models.moe.combine_scatter``: every slot's row
scatter-added with ``index_add_``) on the real router's choices for
numpy-seeded logits.  The two add the same products in another order, so
they agree within float32 rounding: k ulps of the sum of the terms'
magnitudes; on integer values they agree exactly.  The kernel itself is
held to this plain version on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.moe_combine import kernel, ops, ref
from repro_torch.models import moe as M

EXPERTS = [(32, 8), (16, 2), (4, 1)]
TOKENS = [1, 7, 4096]
D = 16


def _cfg(e, k, capacity_factor):
    return dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                               moe=MoEConfig(e, k, capacity_factor))


def _routed(t, e, k, capacity_factor, seed, integer=False):
    """Route numpy-seeded logits; expert outputs [E, C, D] drawn beside
    them (small integers, and integer gates, with ``integer``)."""
    rng = np.random.default_rng(seed)
    logits = torch.tensor(rng.standard_normal((t, e)), dtype=torch.float32)
    r = dict(zip(M.ROUTE_KEYS, M._route(logits, _cfg(e, k,
                                                      capacity_factor))))
    c = r["token_ids"].shape[1]
    if integer:
        out = rng.integers(-8, 9, (e, c, D))
        r["combine_w"] = r["mask"] * torch.tensor(
            rng.integers(1, 5, (t, e)), dtype=torch.float32)
    else:
        out = rng.standard_normal((e, c, D))
    r["out"] = torch.tensor(out, dtype=torch.float32)
    return r


def _gather(r, out=None, combine_w=None):
    return ref.moe_combine_ref(r["out"] if out is None else out,
                               r["combine_w"] if combine_w is None
                               else combine_w,
                               r["gate_idx"], r["token_ids"],
                               r["gathered_mask"])


def _no_drops(e, k):
    """The capacity factor that gives every expert a slot for each token."""
    return e / k


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("e,k", EXPERTS)
@pytest.mark.parametrize("drops", ["none", "some", "many"])
def test_gather_matches_the_scatter_add_combine(t, e, k, drops):
    factor = {"none": _no_drops(e, k), "some": 1.25, "many": 0.5}[drops]
    r = _routed(t, e, k, factor, seed=t * 100 + e + k)
    if drops == "none":
        assert M.dropped(r) == 0
    elif drops == "many" and t > 1:
        assert M.dropped(r) > 0
    got = _gather(r)
    want = M.combine_scatter(r["out"], r["combine_w"], r["token_ids"], t)
    # both sum the same k (or fewer) products in float32, in another order
    scale = _gather(r, r["out"].abs(), r["combine_w"].abs())
    bound = 2 * k * torch.finfo(torch.float32).eps * scale
    assert got.dtype == want.dtype == torch.float32
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("e,k", EXPERTS)
def test_gather_equals_the_scatter_add_on_integers(t, e, k):
    r = _routed(t, e, k, 0.5, seed=t + 7 * e, integer=True)
    torch.testing.assert_close(
        _gather(r), M.combine_scatter(r["out"], r["combine_w"],
                                      r["token_ids"], t), rtol=0, atol=0)


@pytest.mark.parametrize("t", [7, 64])
@pytest.mark.parametrize("e,k", EXPERTS)
def test_dropped_assignments_add_nothing_and_padding_is_never_read(t, e, k):
    """Each token's sum holds exactly its kept (token, expert) pairs,
    found by a loop over the slots; padding rows poisoned with NaN leave
    the result finite."""
    r = _routed(t, e, k, 0.5, seed=3 * t + e, integer=True)
    out = r["out"].clone()
    out[r["gathered_mask"] == 0] = float("nan")
    got = _gather(r, out)
    assert torch.isfinite(got).all()
    want = torch.zeros_like(got)
    kept = 0
    for ex in range(e):
        for s in range(r["token_ids"].shape[1]):
            if r["gathered_mask"][ex, s]:
                tok = int(r["token_ids"][ex, s])
                assert ex in r["gate_idx"][tok].tolist()
                want[tok] += r["combine_w"][tok, ex] * out[ex, s]
                kept += 1
    assert kept == t * k - M.dropped(r)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("e,k", EXPERTS)
def test_slot_map_names_each_kept_slot_once(t, e, k):
    r = _routed(t, e, k, 0.5, seed=t + e * k)
    slots = ref.slot_map(r["gate_idx"], r["token_ids"], r["gathered_mask"])
    c = r["token_ids"].shape[1]
    assert slots.shape == (t, k)
    assert int((slots < 0).sum()) == M.dropped(r)
    named = slots[slots >= 0]
    assert named.unique().numel() == named.numel()
    kept = torch.nonzero(r["gathered_mask"].reshape(-1)).reshape(-1)
    assert torch.equal(named.sort().values, kept)
    # slot e C + s of token t at place j: expert gate_idx[t, j] holds t
    tok, j = torch.nonzero(slots >= 0, as_tuple=True)
    s = slots[tok, j]
    assert torch.equal(r["gate_idx"][tok, j], s // c)
    assert torch.equal(r["token_ids"].reshape(-1)[s], tok)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_the_op_takes_the_plain_version_on_the_cpu(dtype):
    """CPU tensors never reach the kernel (its counter stays put), the
    sum is float32 rounded once to ``out``'s dtype, and the kernel's
    wrapper refuses them."""
    r = _routed(64, 16, 2, 1.25, seed=5)
    out = r["out"].to(dtype)
    args = (r["combine_w"], r["gate_idx"], r["token_ids"],
            r["gathered_mask"])
    reset_launch_counts()
    got = ops.moe_combine(out, *args)
    assert launch_counts().get("moe_combine", 0) == 0
    assert got.dtype == dtype
    assert torch.equal(got, _gather(r, out.float()).to(dtype))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.moe_combine_kernel(out, *args)


@pytest.mark.parametrize("device", ["meta", "cuda"])
def test_the_op_runs_on_fake_and_meta_tensors(device):
    """On meta tensors and on fake CUDA tensors (the dry run's on the
    card) the op gives the output's shape and dtype and launches
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    r = _routed(64, 16, 2, 1.25, seed=6)
    args = [r["out"].to(torch.bfloat16), r["combine_w"], r["gate_idx"],
            r["token_ids"], r["gathered_mask"]]
    reset_launch_counts()
    with FakeTensorMode() if device == "cuda" else torch.no_grad():
        got = ops.moe_combine(*(torch.empty(a.shape, dtype=a.dtype,
                                            device=device) for a in args))
    assert got.shape == (64, D) and got.dtype == torch.bfloat16
    assert got.device.type == device
    assert launch_counts().get("moe_combine", 0) == 0


def test_moe_ffn_on_the_cpu_keeps_the_scatter_add():
    """``moe_ffn``'s combine on CPU tensors is ``combine_scatter`` even
    where autograd does not record, and launches no kernel."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = M.init_moe(gen, cfg)
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 9, cfg.d_model)), dtype=torch.float32)
    reset_launch_counts()
    with torch.no_grad():
        y, _ = M.moe_ffn(params, x, cfg)
    assert launch_counts().get("moe_combine", 0) == 0
    xt = x.reshape(-1, cfg.d_model)
    r = M.route(params, xt, cfg)
    xg = xt[r["token_ids"].reshape(-1)].reshape(
        *r["token_ids"].shape, -1) * r["gathered_mask"][..., None]
    up = torch.einsum("ecd,edf->ecf", xg, params["w_up"])
    gate = torch.einsum("ecd,edf->ecf", xg, params["w_gate"])
    out = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(gate) * up,
                       params["w_down"])
    want = M.combine_scatter(out, r["combine_w"], r["token_ids"], 18)
    torch.testing.assert_close(y.reshape(18, -1), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("k,d,dtype,want", [
    (8, 1024, torch.bfloat16, 1), (2, 4096, torch.bfloat16, 4),
    (1, 1024, torch.bfloat16, 8), (3, 1024, torch.float32, 2),
    (2, 24, torch.bfloat16, 1), (1, 8, torch.float32, 2),
    (16, 64, torch.float16, 1)])
def test_vectors_a_thread_rule(k, d, dtype, want):
    """The launcher's split, mirrored: 8 / k vectors a thread rounded down
    to a power of two, halved until it divides the row's 16-byte vectors
    (the kernel reads the choice from the wrapper)."""
    assert kernel.vectors_a_thread(k, d, dtype) == want
