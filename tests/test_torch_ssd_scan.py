"""The SSD scan op (``kernels/ssd_scan``): Mamba2's chunked scan with one
group of B and C.

On the CPU: the op's CPU route is the plain ``chunked_linear_scan`` bit
for bit; its fake implementation gives the outputs' shapes and dtypes; the
kernel's wrapper refuses what it does not take; the Mamba2 mixer takes the
op where autograd does not record (on the CPU, and on fake CUDA tensors)
and the plain scan where it does; the mLSTM always takes the plain scan;
a traced Granite prefill opens one ``chunked_linear_scan`` span a Mamba2
layer, none inside another.

On the card (``cuda``-marked; skipped elsewhere): the kernel against the
plain version on the same inputs, both held to the recurrence taken a
token at a time in float64, at Granite 4.0-H's and zamba2's widths:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_scan.py

Tolerances on the card.  bf16 (unit roundoff u = 2^-8): y is rounded
once, and each of its terms meets at most three bf16 roundings on its way
(the decayed x of a chunk state, that state, and the chunk's starting
state; within a chunk only the decayed C B^T entry), so each element of
y lies within u |y| + 3 u S of the float64 recurrence, S the same
recurrence over |x|, |B|, |C| and |h0| (a bound on the sum of its terms'
magnitudes); the final state, in float32, meets the first two, so 2 u
S_h.  The sums themselves are float32: 2^-16 S more covers them.
float32: each output sums at most chunk + N products of a few float32
roundings each, so (chunk + N) x 4 x 2^-24 S.  In bf16 the kernel also
has to be at least as close to the float64 recurrence as the plain
version is, by the rms over every element: it rounds the same values to
bf16 no more often.  In float32 both take every product and sum in
float32, in other orders, so their errors are of one kind and either
may be the larger on given inputs: the kernel's rms is held within twice
the plain version's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.models import build, ssm

GRANITE = "granite-4.0-h-small"


def _inputs(b, s, h, p, n, g=1, dtype=torch.float32, with_h0=False,
            seed=0, device="cpu"):
    """x (dt-scaled), B, C [b, s, g, n], loga and h0 as the Mamba2 mixer
    makes them: dt log-uniform in [0.001, 0.1], A in [1, 16] (Mamba2's
    init ranges)."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    a = np.exp(rng.uniform(0.0, np.log(16.0), (h,)))
    x = rng.standard_normal((b, s, h, p)) * dt[..., None]
    B, C = (rng.standard_normal((b, s, g, n)) for _ in range(2))
    h0 = rng.standard_normal((b, h, n, p)) if with_h0 else None

    def t(v, dt_=dtype):
        return torch.tensor(v, dtype=dt_, device=device)
    return (t(x), t(B), t(C), t(-dt * a, torch.float32),
            None if h0 is None else t(h0, torch.float32))


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------
@pytest.fixture()
def cpu():
    with runtime.use_device("cpu"):
        yield


@pytest.mark.parametrize("s,chunk,groups,with_h0,dtype", [
    (37, 16, 1, False, torch.float32), (64, 16, 1, True, torch.float32),
    (5, 16, 1, True, torch.float32), (40, 8, 3, False, torch.float32),
    (37, 16, 1, True, torch.bfloat16), (300, 128, 1, False, torch.bfloat16)])
def test_the_op_on_the_cpu_is_the_plain_scan(cpu, s, chunk, groups, with_h0,
                                             dtype):
    x, B, C, loga, h0 = _inputs(2, s, 3, 8, 4, groups, dtype, with_h0,
                                seed=s + chunk)
    reset_launch_counts()
    got_y, got_h = ops.ssd_scan(x, B, C, loga, chunk, h0)
    want_y, want_h = ssm.chunked_linear_scan(x, B, C, loga, chunk, h0)
    assert launch_counts().get("ssd_scan", 0) == 0
    assert got_y.dtype == dtype and got_h.dtype == torch.float32
    assert torch.equal(got_y, want_y) and torch.equal(got_h, want_h)


@pytest.mark.parametrize("device", ["meta", "cuda"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_fake_implementation_gives_the_shapes_and_dtypes(device, dtype):
    """On meta tensors and on fake CUDA tensors (the dry run's on the
    card) the op gives y in x's shape and dtype and the final state
    [b, h, n, p] in float32, and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shapes = [((2, 300, 8, 64), dtype), ((2, 300, 1, 128), dtype),
              ((2, 300, 1, 128), dtype), ((2, 300, 8), torch.float32)]
    reset_launch_counts()
    with FakeTensorMode() if device == "cuda" else torch.no_grad():
        args = [torch.empty(sh, dtype=dt, device=device)
                for sh, dt in shapes]
        y, h_final = ops.ssd_scan(*args, 256)
    assert y.shape == (2, 300, 8, 64) and y.dtype == dtype
    assert h_final.shape == (2, 8, 128, 64)
    assert h_final.dtype == torch.float32
    assert y.device.type == h_final.device.type == device
    assert launch_counts().get("ssd_scan", 0) == 0


def test_the_kernel_refuses_cpu_tensors(cpu):
    args = _inputs(1, 300, 4, 64, 64)[:4]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_scan_kernel(*args, 128)


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float16), "bfloat16 or float32"),
    (dict(g=2), "one group"),
    (dict(n=32), "N and P"), (dict(p=96), "N and P"),
    (dict(chunk=64), "chunks"), (dict(loga=torch.bfloat16), "loga"),
    (dict(h0=torch.bfloat16), "h0"), (dict(strided=True), "unit stride")])
def test_the_kernel_refuses_what_it_does_not_take(change, match):
    """On fake CUDA tensors, so the wrapper's checks run without a card:
    each input the kernel does not take raises before any launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dims = dict(b=1, s=300, h=4, p=64, n=128, g=1, chunk=256,
                dtype=torch.bfloat16)
    dims.update({k: v for k, v in change.items() if k in dims})
    b, s, h, p, n, g = (dims[k] for k in "bshpng")
    with FakeTensorMode():
        def t(*shape, dtype=dims["dtype"]):
            return torch.empty(shape, dtype=dtype, device="cuda")
        x = t(b, s, h, p)
        if change.get("strided"):
            x = torch.empty_strided(x.shape, (s * h * p, h * p, 1, h),
                                    dtype=x.dtype, device="cuda")
        args = (x, t(b, s, g, n), t(b, s, g, n),
                t(b, s, h, dtype=change.get("loga", torch.float32)),
                dims["chunk"], t(b, h, n, p,
                                 dtype=change.get("h0", torch.float32)))
        reset_launch_counts()
        with pytest.raises(ValueError, match=match):
            kernel.ssd_scan_kernel(*args)
    assert launch_counts().get("ssd_scan", 0) == 0


def _kernel_widths(cfg):
    """``cfg`` with Mamba2 widths the kernel takes (N 64, head dim 64,
    chunks of 128) in float32 compute."""
    return dataclasses.replace(cfg, ssm_state=64, ssm_head_dim=64,
                               ssm_chunk=128, compute_dtype="float32")


def _count_scans(monkeypatch, call_through=True):
    """Count the calls of the op and of the plain scan that ``models.ssm``
    makes; with ``call_through`` False neither runs (each returns empty
    outputs of the right shapes: fake CUDA tensors run no op here)."""
    calls = {"op": 0, "plain": 0}

    def spy(name, fn):
        def counted(x, B, C, loga, chunk, h0=None):
            calls[name] += 1
            if call_through:
                return fn(x, B, C, loga, chunk, h0)
            b, s, h, p = x.shape
            return (x.new_empty(x.shape),
                    x.new_empty((b, h, B.shape[-1], p), dtype=torch.float32))
        return counted
    monkeypatch.setattr(ssm, "ssd_scan", spy("op", ssm.ssd_scan))
    monkeypatch.setattr(ssm, "chunked_linear_scan",
                        spy("plain", ssm.chunked_linear_scan))
    return calls


@pytest.mark.parametrize("device,grad,route", [
    ("cuda", False, "op"), ("cuda", True, "plain"), ("cpu", False, "op"),
    ("cpu", True, "plain")])
def test_mamba2_takes_the_op_on_cuda_without_autograd(monkeypatch, device,
                                                       grad, route):
    """Mamba2's scan is the op where autograd does not record, on CUDA
    tensors (fake ones here: the dry run's) as on the CPU, whose route is
    the plain scan; under a recorded forward it is the plain scan itself,
    which autograd can record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = _count_scans(monkeypatch, call_through=False)
    with FakeTensorMode() if device == "cuda" else torch.no_grad():
        x, B, C, loga = (torch.empty(sh, dtype=dt, device=device) for sh, dt
                         in (((2, 300, 8, 64), torch.bfloat16),
                             ((2, 300, 1, 128), torch.bfloat16),
                             ((2, 300, 1, 128), torch.bfloat16),
                             ((2, 300, 8), torch.float32)))
        loga.requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y, h_final = ssm.mamba2_scan(x, B, C, loga, 256)
    assert calls == {"op": int(route == "op"), "plain": int(route == "plain")}
    assert y.shape == x.shape and h_final.shape == (2, 8, 128, 64)


def test_the_mixer_scans_through_mamba2_scan_once(cpu, monkeypatch):
    """A Mamba2 mixer's prefill takes its scan from :func:`mamba2_scan`,
    once, with one group of B and C."""
    cfg = dataclasses.replace(get_smoke_config(GRANITE),
                              compute_dtype="float32")
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg, "cpu")
    seen = []
    scan = ssm.mamba2_scan

    def spy(x, B, C, loga, chunk):
        seen.append((B.shape[2], chunk))
        return scan(x, B, C, loga, chunk)
    monkeypatch.setattr(ssm, "mamba2_scan", spy)
    with torch.no_grad():
        ssm.mamba2_prefill(p, torch.zeros((2, 20, cfg.d_model)), cfg)
    assert seen == [(1, cfg.ssm_chunk)]


def test_the_mlstm_keeps_the_plain_scan(cpu, monkeypatch):
    """The mLSTM (its per-head 512 x 512 state does not fit on chip as
    Mamba2's does) calls the plain scan itself, never through
    :func:`mamba2_scan` or the op (its card test: the same on CUDA)."""
    cfg = dataclasses.replace(get_smoke_config("xlstm-350m"),
                              compute_dtype="float32")
    p = ssm.init_mlstm(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = _count_scans(monkeypatch)
    monkeypatch.setattr(ssm, "mamba2_scan", None)
    with torch.no_grad():
        ssm.mlstm_forward(p, torch.zeros((2, 40, cfg.d_model)), cfg)
    assert calls == {"op": 0, "plain": 1}


def test_a_traced_granite_prefill_opens_one_unnested_scan_span_a_layer(cpu):
    """Each Mamba2 layer's scan is exactly one ``chunked_linear_scan``
    span, inside its ``mamba2`` span, and no such span lies inside
    another (a reader multiplies the scan's least time by the count)."""
    cfg = dataclasses.replace(get_smoke_config(GRANITE),
                              compute_dtype="float32")
    model = build(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 19),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.prefill(params, tokens, 20)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name == "chunked_linear_scan")
    mixers = [(e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name == "mamba2"]
    assert len(spans) == len(mixers) == cfg.layer_types.count("mamba")
    for (lo, hi), (nlo, _) in zip(spans, spans[1:]):
        assert hi <= nlo
    for lo, hi in spans:
        assert sum(a <= lo and hi <= b for a, b in mixers) == 1


def test_the_op_on_the_cpu_opens_one_span(cpu):
    x, B, C, loga, _ = _inputs(1, 50, 2, 8, 4, seed=9)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ops.ssd_scan(x, B, C, loga, 16)
    assert sum(e.name == "chunked_linear_scan" for e in prof.events()) == 1


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    with runtime.use_device("cuda") as dev:
        yield dev


def _recurrence(x, B, C, loga, h0=None):
    """The scan a token at a time in float64: h_t = exp(clamp(loga_t,
    -60, 0)) h_{t-1} + B_t x_t^T, y_t = C_t . h_t (one group)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    x, B, C = x.double(), B[:, :, 0].double(), C[:, :, 0].double()
    decay = torch.exp(torch.clamp(loga.double(), -60.0, 0.0))
    hs = (torch.zeros((b, h, n, p), dtype=torch.float64, device=x.device)
          if h0 is None else h0.double())
    ys = torch.empty((b, s, h, p), dtype=torch.float64, device=x.device)
    for t in range(s):
        hs = decay[:, t, :, None, None] * hs + \
            B[:, t, None, :, None] * x[:, t, :, None, :]
        ys[:, t] = torch.einsum("bn,bhnp->bhp", C[:, t], hs)
    return ys, hs


def _assert_within_bound(args, chunk):
    """The kernel against the float64 recurrence within the module's
    bound, and at least as close to it (rms) as the plain version on the
    same inputs."""
    x, B, C, loga, h0 = args
    reset_launch_counts()
    y, hf = kernel.ssd_scan_kernel(x, B, C, loga, chunk, h0)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan"] == 1
    assert y.dtype == x.dtype and hf.dtype == torch.float32
    py, ph = ssm.chunked_linear_scan(x, B, C, loga, chunk, h0)
    ry, rh = _recurrence(x, B, C, loga, h0)
    sy, sh = _recurrence(x.abs(), B.abs(), C.abs(), loga,
                         None if h0 is None else h0.abs())
    if x.dtype == torch.bfloat16:
        u = 2.0 ** -8
        bound_y = u * ry.abs() + (3 * u + 2.0 ** -16) * sy
        bound_h = (2 * u + 2.0 ** -16) * sh
    else:
        k = (chunk + B.shape[-1]) * 4 * 2.0 ** -24
        bound_y, bound_h = k * sy, k * sh
    err_y, err_h = (y.double() - ry).abs(), (hf.double() - rh).abs()
    assert (err_y <= bound_y).all(), float((err_y / bound_y).max())
    assert (err_h <= bound_h).all(), float((err_h / bound_h).max())

    def rms(a, b):
        return float((a.double() - b).pow(2).mean().sqrt())
    worse = 1.0 if x.dtype == torch.bfloat16 else 2.0
    assert rms(y, ry) <= worse * rms(py, ry)
    assert rms(hf, rh) <= worse * rms(ph, rh)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [8192, 4100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_the_kernel_at_granite_4_h_small_widths(cuda, s, with_h0):
    """128 heads of 64, N 128, one group, chunks of 256, bf16; 4,100
    tokens leave a ragged last chunk."""
    _assert_within_bound(_inputs(1, s, 128, 64, 128, dtype=torch.bfloat16,
                                 with_h0=with_h0, seed=s, device=cuda), 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_at_zamba2_widths(cuda, dtype):
    """64 heads of 64, N 64, chunks of 128 (zamba2-1.2b's), two prompts."""
    _assert_within_bound(_inputs(2, 2048, 64, 64, 64, dtype=dtype,
                                 with_h0=True, seed=7, device=cuda), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("s,chunk", [(1000, 256), (64, 128), (1, 256)])
def test_the_kernel_in_float32_and_short_prompts(cuda, s, chunk):
    """float32 at Granite's widths, and prompts shorter than a chunk."""
    _assert_within_bound(_inputs(1, s, 128, 64, 128, with_h0=s < 100,
                                 seed=s, device=cuda), chunk)


@pytest.mark.cuda
def test_two_calls_are_bit_equal(cuda):
    x, B, C, loga, h0 = _inputs(1, 8192, 128, 64, 128, dtype=torch.bfloat16,
                                with_h0=True, seed=3, device=cuda)
    y1, h1 = kernel.ssd_scan_kernel(x, B, C, loga, 256, h0)
    y2, h2 = kernel.ssd_scan_kernel(x, B, C, loga, 256, h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_the_kernel_reads_b_and_c_through_their_strides(cuda):
    """B and C as the mixer gives them: views into the conv's output,
    whose rows are wider than N."""
    x, B, C, loga, _ = _inputs(1, 700, 128, 64, 128, dtype=torch.bfloat16,
                               seed=4, device=cuda)
    wide = torch.cat([B, C, torch.ones_like(B)], dim=-1)
    Bv, Cv = wide[..., :128], wide[..., 128:256]
    assert Bv.stride(1) == 384
    want = kernel.ssd_scan_kernel(x, B, C, loga, 256)
    got = kernel.ssd_scan_kernel(x, Bv, Cv, loga, 256)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_a_prefill_launches_one_scan_a_mamba2_layer(cuda):
    """Granite's smoke model at the kernel's widths: a prefill without
    autograd launches the kernel once a Mamba2 layer and gives the CPU's
    plain numbers (float32) to 1e-4, a forward with autograd recording
    launches none."""
    from repro_torch.models.convert import tree_to
    cfg = _kernel_widths(get_smoke_config(GRANITE))
    model = build(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 300),
                           generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = model.forward(params, tokens)[0]
        reset_launch_counts()
        got = model.forward(tree_to(params, cuda), tokens.to(cuda))[0]
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan"] == cfg.layer_types.count("mamba")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    on_card = tree_to(params, cuda)
    for layer in on_card["layers"]:
        for v in layer.get("mamba", {}).values():
            v.requires_grad_(True)
    reset_launch_counts()
    model.forward(on_card, tokens.to(cuda))[0].sum().backward()
    assert launch_counts().get("ssd_scan", 0) == 0


@pytest.mark.cuda
def test_the_mlstm_launches_no_scan_kernel_on_the_card(cuda):
    """xlstm-350m's smoke mLSTM on the card without autograd: the plain
    scan, no ``ssd_scan`` launch, the CPU's numbers (float32) to 1e-4."""
    from repro_torch.models.convert import tree_to
    cfg = dataclasses.replace(get_smoke_config("xlstm-350m"),
                              compute_dtype="float32")
    p = ssm.init_mlstm(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 300, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ssm.mlstm_forward(p, x, cfg)
        reset_launch_counts()
        got = ssm.mlstm_forward(tree_to(p, cuda), x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert launch_counts().get("ssd_scan", 0) == 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float16), "bfloat16 or float32"), (dict(g=2), "group"),
    (dict(n=16), "N and P"), (dict(chunk=64), "chunks"),
    (dict(cpu_b=True), "on cuda")])
def test_the_kernel_refuses_on_the_card(cuda, change, match):
    dims = dict(b=1, s=300, h=4, p=64, n=128, g=1, chunk=256,
                dtype=torch.float32)
    dims.update({k: v for k, v in change.items() if k in dims})
    x, B, C, loga, _ = _inputs(*(dims[k] for k in "bshpng"),
                               dtype=dims["dtype"], device=cuda)
    if change.get("cpu_b"):
        B = B.cpu()
    reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        kernel.ssd_scan_kernel(x, B, C, loga, dims["chunk"])
    assert launch_counts().get("ssd_scan", 0) == 0
