"""The dry run (``repro_torch.launch.dryrun``, the twin of
``repro/launch/dryrun.py``) on the CPU: every count per chip, on a fake
process group.

* Its pure functions against the reference's, exactly: ``input_specs``'
  shapes and dtypes, ``pick_microbatch`` over every arch x shape x mesh,
  ``extrapolate``, ``predicted_terms`` and ``roofline_terms`` on
  ``TPU_V5E``.  In a subprocess only: importing the reference's module
  sets ``XLA_FLAGS`` to 512 forced host devices, which must not leak into
  this worker or the processes it spawns.
* Per-chip FLOPs on a data-only fake mesh ``(n, 1)``, times ``n``, equal
  the one-device count exactly (a counter of global DTensor ops would
  count ``n`` times too much).
* The one-device count of the dense smoke train step equals a hand
  count of its matrix products, exactly.
* The probe extrapolation equals the full-depth count, exactly for
  FLOPs, on one device and on a ``(2, 2)`` fake mesh.
* The gradient all-reduce of an ``fsdp=False`` cell moves 2 x the
  parameters' float32 bytes / tp, within the few scalars the loss's
  reductions add.
* Kernel K5's op: its fake implementation gives ``attention_ref``'s
  shape, dtype and layout, and its flop formula ``4 B H D`` x the
  (query, key) pairs the mask keeps, causal and ragged.
* One production cell at full width: qwen2-1.5b ``train_4k`` on the
  ``(16, 16)`` fake mesh with probes, through the CLI, within 300 s.

The reference's own lowering of a cell (``jax.make_mesh``'s Explicit
axes) is not compared: its counts are XLA's, the port's are the local
ops it runs (``PERF.md`` states how the two differ).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import build

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

_PARITY = r"""
import json
import sys

sys.path.insert(0, sys.argv[1])
from repro.launch import dryrun as R      # sets XLA_FLAGS first
from repro.configs import get_config as r_config
from repro.configs.base import SHAPES as R_SHAPES
from repro.launch.mesh import make_production_mesh as r_mesh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.hardware import TPU_V5E
from repro_torch.launch import dryrun as P
from repro_torch.launch.mesh import make_production_mesh

bad, n = [], {"input_specs": 0, "pick_microbatch": 0, "predicted_terms": 0,
              "roofline_terms": 0, "extrapolate": 0}
meshes = {k: (r_mesh(multi_pod=k == "multi"),
              make_production_mesh(multi_pod=k == "multi"))
          for k in ("single", "multi")}
probe = lambda f, b, c: {"flops": f, "bytes_accessed": b,
                         "collectives": {"moved_bytes_per_chip": c}}
for arch in ARCH_IDS:
    cr, cp = r_config(arch), get_config(arch)
    for s in SHAPES:
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in R.input_specs(cr, R_SHAPES[s]).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in P.input_specs(cp, SHAPES[s]).items()}
        n["input_specs"] += 1
        if got != want:
            bad.append(["input_specs", arch, s, str(got), str(want)])
        for kind, (rm, pm) in meshes.items():
            for sp in (True, False):
                a = R.pick_microbatch(cr, R_SHAPES[s], rm, sp)
                b = P.pick_microbatch(cp, SHAPES[s], pm, sp)
                n["pick_microbatch"] += 1
                if a != b:
                    bad.append(["pick_microbatch", arch, s, kind, sp, b, a])
            a = R.predicted_terms(cr, s, kind)
            b = P.predicted_terms(cp, s, kind, TPU_V5E)
            n["predicted_terms"] += 1
            if a != b:
                bad.append(["predicted_terms", arch, s, kind, b, a])
        p1 = probe(1.5e12 + len(arch), 3.25e10, 7.0e8)
        p2 = probe(2.75e12 + len(arch), 5.5e10, 1.3e9 + len(s))
        for period in (2, 4, 6):
            a = R.extrapolate(cr, p1, p2, period)
            b = P.extrapolate(cp, p1, p2, period)
            n["extrapolate"] += 1
            if a != b:
                bad.append(["extrapolate", arch, s, period, b, a])
        full = {"full": {"flops": 4.0e15, "bytes_accessed": 2.0e12,
                         "collectives": {"moved_bytes_per_chip": 3.0e11}}}
        for record in (full, dict(full, extrapolated=P.extrapolate(
                cp, p1, p2, 2))):
            for kind in ("single", "multi"):
                a = R.roofline_terms(cr, R_SHAPES[s], kind, record)
                b = P.roofline_terms(cp, SHAPES[s], kind, record, TPU_V5E)
                n["roofline_terms"] += 1
                if a != b:
                    bad.append(["roofline_terms", arch, s, kind, b, a])
print(json.dumps({"bad": bad, "n": n}, default=str))
"""


def test_pure_functions_equal_the_reference_exactly(tmp_path):
    script = tmp_path / "parity.py"
    script.write_text(_PARITY)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(script), SRC], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    # ten configs x four shapes; x two meshes x sp on/off; x three
    # periods; x two records x two meshes
    assert out["n"] == {"input_specs": 40, "pick_microbatch": 160,
                        "predicted_terms": 80, "extrapolate": 120,
                        "roofline_terms": 160}


def _dense(**kw):
    return dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                               compute_dtype="float32", **kw)


ONE = Mesh(("data", "model"), (1, 1))
SHAPE_KINDS = {"train": ShapeConfig("t", 32, 8, "train"),
               "prefill": ShapeConfig("p", 32, 8, "prefill"),
               "decode": ShapeConfig("d", 64, 8, "decode")}


def _count(cfg, shape, mesh, **kw):
    kw.setdefault("device", "cpu")
    if mesh.trivial:
        return dryrun.extract_costs(dryrun.lower_cell(cfg, shape, mesh,
                                                      **kw))
    with dryrun.fake_process_group(mesh.size):
        mesh = make_mesh(mesh.sizes, mesh.axis_names, devices="cpu")
        return dryrun.extract_costs(dryrun.lower_cell(cfg, shape, mesh,
                                                      **kw))


@pytest.mark.parametrize("kind,microbatch", [("train", None),
                                              ("train", 4),
                                              ("prefill", None),
                                              ("decode", None)])
def test_per_chip_flops_times_the_data_ways_equal_one_device(kind,
                                                             microbatch):
    """On a data-only mesh every product splits by the batch: 4 chips
    each count a quarter of the one-device FLOPs, exactly; with gradient
    accumulation too (two microbatches of 4 rows)."""
    cfg, shape = _dense(), SHAPE_KINDS[kind]
    one = _count(cfg, shape, ONE, microbatch=microbatch)
    four = _count(cfg, shape, Mesh(("data", "model"), (4, 1)),
                  microbatch=microbatch)
    assert one["flops"] > 0
    assert four["flops"] * 4 == one["flops"]


def _hand_train_flops(cfg, b, s):
    """The smoke train step's matrix FLOPs: each layer's projections,
    its two attention products (the plain path computes every (query,
    key) pair) and its three MLP products, forward once and backward
    twice (no remat); the tied unembedding of the one CE slice forward,
    recomputed (checkpointed) and backward twice."""
    t, d, f, v = b * s, cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    proj = 2 * t * d * hd * (h + 2 * kh) + 2 * t * h * hd * d
    attn = 2 * (2 * b * h * s * s * hd)
    mlp = 3 * 2 * t * d * f
    layer = proj + attn + mlp
    return 3 * cfg.n_layers * layer + 4 * 2 * t * d * v


def test_one_device_train_step_equals_a_hand_count():
    cfg, shape = _dense(), SHAPE_KINDS["train"]
    got = _count(cfg, shape, ONE)
    assert not cfg.remat and cfg.tie_embeddings
    assert got["flops"] == _hand_train_flops(cfg, shape.global_batch,
                                             shape.seq_len)
    assert got["collectives"]["moved_bytes_per_chip"] == 0
    assert got["bytes_accessed"] > 0


@pytest.mark.parametrize("sizes", [(1, 1), (2, 2)])
def test_probe_extrapolation_equals_the_full_depth_count(sizes):
    """f(L) = a + b L from the reference's probe depths (2 and 4 layers)
    at the full depth of 6: the FLOPs exactly; bytes and collective
    bytes within 1e-9 relative (float arithmetic of the fit)."""
    mesh = Mesh(("data", "model"), sizes)
    cfg, shape = _dense(n_layers=6), SHAPE_KINDS["train"]
    full = _count(cfg, shape, mesh)
    p1 = _count(dryrun.probe_config(cfg, 2), shape, mesh)
    p2 = _count(dryrun.probe_config(cfg, 4), shape, mesh)
    got = dryrun.extrapolate(cfg, p1, p2, 2)
    assert got["flops"] == full["flops"]
    np.testing.assert_allclose(got["bytes_accessed"],
                               full["bytes_accessed"], rtol=1e-9)
    np.testing.assert_allclose(
        got["collective_bytes"],
        full["collectives"]["moved_bytes_per_chip"], rtol=1e-9)


def test_fsdp_off_gradient_all_reduce_moves_the_parameters_twice():
    """Parameters replicated over 4 data ranks (tp = 1): each gradient is
    a partial sum all-reduced whole, a ring moving 2x its float32 bytes.
    The all-reduces beyond the parameters are the loss's scalar
    reductions, at most 16 float32 values."""
    cfg, shape = _dense(), SHAPE_KINDS["train"]
    got = _count(cfg, shape, Mesh(("data", "model"), (4, 1)), fsdp=False)
    with runtime.use_device("cpu"):
        n_params = sum(p.numel() for p in torch.utils._pytree.tree_leaves(
            build(cfg).init(0, device="meta")))
    tp = 1
    coll = got["collectives"]
    reduced = coll["per_kind_result_bytes"]["all-reduce"]
    assert n_params * 4 / tp <= reduced <= n_params * 4 / tp + 16 * 4
    assert coll["moved_bytes_per_chip"] >= 2 * n_params * 4 / tp
    assert coll["per_kind_result_bytes"]["reduce-scatter"] == 0


@pytest.mark.parametrize("sq,skv,causal", [(48, 48, True), (48, 20, True),
                                           (20, 48, True), (48, 20, False)])
def test_k5_fake_impl_and_flop_formula(sq, skv, causal):
    """On fake CUDA tensors K5's op returns ``attention_ref``'s shape,
    dtype and strides, and FlopCounterMode counts 4 B H D x the pairs
    the top-left aligned causal mask keeps (every pair without it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    b, h, kh, d = 2, 4, 2, 16
    q = torch.randn(b, h, sq, d)
    k = torch.randn(b, kh, skv, d)
    want = fa_ops.attention_ref(q, k, k, causal=causal)
    mask = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
    pairs = int(mask.sum()) if causal else sq * skv
    assert fa_ops.kept_pairs(sq, skv, causal) == pairs
    with FakeTensorMode():
        fq = torch.empty(b, sq, h, d, device="cuda").transpose(1, 2)
        fk = torch.empty(b, kh, skv, d, device="cuda")
        with FlopCounterMode(display=False) as counter:
            out = fa_ops.flash_attention(fq, fk, fk, causal)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert out.stride() == fq.stride() and out.device.type == "cuda"
    assert counter.get_total_flops() == 4 * b * h * d * pairs


def test_production_cell_at_full_width(tmp_path):
    """qwen2-1.5b ``train_4k`` (256 x 4,096 tokens) on the (16, 16) fake
    mesh, kernel K5's op for attention, with probes, through the CLI on
    meta tensors: a record with the reference's keys, counts that
    are positive and finite, and K5's FLOPs counted by its formula."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "train_4k", "--mesh", "single",
         "--device", "meta", "--attn-impl", "flash", "--out-dir",
         str(tmp_path)], env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "qwen2-1.5b__train_4k__single.json") as fh:
        record = json.load(fh)
    for key in ("full", "probes", "extrapolated", "distcalc", "roofline",
                "roofline_tpu_v5e", "microbatch", "compile_seconds"):
        assert key in record, key
    full = record["full"]
    assert record["mesh_shape"] == {"data": 16, "model": 16}
    assert full["flops"] > 0 and np.isfinite(full["bytes_accessed"])
    assert full["collectives"]["moved_bytes_per_chip"] > 0
    assert full["flops"] == record["extrapolated"]["flops"]
    assert record["distcalc"]["strategy"]
    assert 0 < record["roofline"]["useful_flops_ratio"] < 1
    assert seconds < 300, seconds
