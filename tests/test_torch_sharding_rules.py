"""The port's sharding rules on the CPU: the twins of
tests/test_sharding_rules.py, and parity with the reference's rules for
every parameter of all ten configs at full size (shapes from
``jax.eval_shape`` in the reference, from the meta device in the port),
on both production meshes, FSDP on and off."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.models import build as r_build
from repro.parallel import ctx as r_ctx
from repro.parallel import sharding as r_sharding
from repro_torch import runtime
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import build
from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import (STACKED, batch_sharding,
                                           cache_shardings, check_realisable,
                                           embeds_sharding, param_shardings,
                                           spec_for_param, state_shardings)
from repro_torch.train.loop import init_state


def mesh_single():
    return p_mesh.make_production_mesh()


def mesh_multi():
    return p_mesh.make_production_mesh(multi_pod=True)


def _r_mesh(mesh):
    """The reference's AbstractMesh of the same axes and sizes."""
    try:  # jax >= 0.4.35: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(mesh.axis_names, mesh.sizes)))
    except TypeError:  # AbstractMesh(sizes, names)
        return AbstractMesh(mesh.sizes, mesh.axis_names)


# ---------------------------------------------------------------------------
# twins of tests/test_sharding_rules.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
def test_attention_projection_sharding(mesh_fn):
    mesh = mesh_fn()
    # llama3-405b wq: [layers, d, heads, hd] = [126, 16384, 128, 128]
    spec = spec_for_param("layers/attn/wq", (126, 16384, 128, 128), mesh)
    assert spec[-2] == "model"          # heads TP-sharded
    assert spec[-3] == "data"           # FSDP on d
    # GQA kv with 8 heads (not divisible by 16): falls back to head_dim
    spec = spec_for_param("layers/attn/wk", (126, 16384, 8, 128), mesh)
    assert spec[-1] == "model" and spec[-2] is None


def test_fsdp_toggle():
    mesh = mesh_single()
    with_fsdp = spec_for_param("layers/mlp/w_gate", (28, 1536, 8960), mesh,
                               fsdp=True)
    without = spec_for_param("layers/mlp/w_gate", (28, 1536, 8960), mesh,
                             fsdp=False)
    assert "data" in with_fsdp
    assert "data" not in without
    assert "model" in without           # TP stays


def test_small_params_stay_replicated():
    mesh = mesh_single()
    spec = spec_for_param("final_norm/scale", (1024,), mesh)
    assert spec in ((), (None,))


def test_moe_expert_parallelism():
    mesh = mesh_single()
    # phi3.5: [32 layers, 16 experts, 4096, 6400]
    spec = spec_for_param("layers/moe/w_gate", (32, 16, 4096, 6400), mesh)
    assert spec[-3] == "model"          # EP on the expert dim
    assert spec[-2] == "data"


def test_vocab_sharding():
    mesh = mesh_single()
    spec = spec_for_param("embed/tok", (128256, 16384), mesh)
    assert spec[-2] == "model"
    spec = spec_for_param("embed/head", (16384, 128256), mesh)
    assert spec[-1] == "model"


def test_indivisible_dims_left_unsharded():
    mesh = mesh_single()
    spec = spec_for_param("embed/tok", (32063, 1536), mesh)
    assert spec[0] is None


def test_ctx_noop_without_mesh():
    x = torch.ones((4, 8, 16))
    assert ctx.constrain_bsd(x) is x
    assert ctx.constrain_residual(x) is x
    assert ctx.get_mesh() is None


def test_ctx_options_restore():
    assert not ctx.sequence_parallel()
    with ctx.options(seq_parallel=True):
        assert ctx.sequence_parallel()
    assert not ctx.sequence_parallel()


def test_ctx_batch_axes_follow_mesh_names():
    assert ctx.batch_axes() == ()
    with ctx.mesh_context(mesh_multi()):
        assert ctx.batch_axes() == ("pod", "data")
    assert ctx.get_mesh() is None


def test_ctx_on_one_device_returns_its_input_and_raises_across_devices():
    """On a mesh whose axes all have size 1 a constraint places nothing;
    on a mesh of several devices it needs a DTensor and raises on a plain
    tensor instead of being dropped (unless it places nothing)."""
    x = torch.ones((32, 8, 16))
    with runtime.use_device("cpu"), ctx.mesh_context(p_mesh.host_mesh()):
        assert ctx.constrain_residual(x) is x
        assert ctx.constrain_logits(x) is x
    with ctx.mesh_context(mesh_single()):
        with pytest.raises(TypeError, match="DTensor"):
            ctx.constrain_bsd(x)
        assert ctx.constrain_bsd(torch.ones((3, 8, 16))).shape == (3, 8, 16)


@pytest.mark.parametrize("spec", [(("pod", "data"), None, "model"),
                                  (None, "model", "data"),
                                  ("data", ("data", "model"), None)])
def test_ctx_resolve_matches_the_reference(spec):
    """The spec a constraint resolves to, against the reference's own
    cleaning (axes off the mesh dropped, indivisible dims unsharded)."""
    shape = (64, 24, 48)
    for mesh in (mesh_single(), mesh_multi()):
        r_mesh = _r_mesh(mesh)
        want = []
        for dim, axis in zip(shape, spec):
            axis = r_ctx._clean_axis(axis, r_mesh)
            if axis is None:
                want.append(None)
                continue
            names = axis if isinstance(axis, tuple) else (axis,)
            size = int(np.prod([r_mesh.shape[a] for a in names]))
            want.append(axis if dim % size == 0 else None)
        assert ctx.resolve(shape, spec, mesh) == tuple(want)


# ---------------------------------------------------------------------------
# parity with the reference, every config at full size
# ---------------------------------------------------------------------------
def _r_leaves(tree):
    return [(r_sharding._path_to_str(path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaf(specs, path: str):
    """The port's specs at the reference's ``path``: every layer's for a
    stacked subtree, else the one."""
    parts = path.split("/")
    if parts[0] in STACKED and isinstance(specs[parts[0]], list):
        nodes = specs[parts[0]]
        parts = parts[1:]
    else:
        nodes = [specs]
    out = []
    for node in nodes:
        for p in parts:
            node = node[int(p)] if isinstance(node, (list, tuple)) and \
                not isinstance(node, dict) and p.isdigit() else node[p]
        out.append(node)
    return out


@pytest.fixture(scope="module")
def shapes():
    """Each config's parameter shapes in both packages (abstract)."""
    out = {}
    for arch in ARCH_IDS:
        ref = jax.eval_shape(r_build(r_get_config(arch)).init,
                             jax.random.PRNGKey(0))
        out[arch] = (_r_leaves(ref), build(get_config(arch)).init(
            0, device="meta"))
    return out


def test_ten_configs_in_both_packages():
    assert tuple(ARCH_IDS) == tuple(R_ARCH_IDS)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(shapes, arch, mesh_fn, fsdp):
    """Every parameter: the reference's spec of its (stacked) tensor, and
    the port's per-layer spec that spec without its leading entry."""
    mesh = mesh_fn()
    r_mesh = _r_mesh(mesh)
    r_leaves, p_params = shapes[arch]
    specs = param_shardings(p_params, mesh, fsdp=fsdp)
    checked = 0
    for path, shape in r_leaves:
        want = tuple(r_sharding.spec_for_param(path, shape, r_mesh,
                                               fsdp=fsdp))
        assert spec_for_param(path, shape, mesh, fsdp=fsdp) == want, path
        got = _port_leaf(specs, path)
        if path.split("/")[0] in STACKED:
            assert len(got) == shape[0], path
            want = want[1:]
        assert all(g == want for g in got), (path, got[0], want)
        checked += len(got)
    assert checked == sum(1 for _ in _port_flat(specs))


def _port_flat(specs, path=""):
    """(path, spec) for every spec of a tree of specs, paths spelled as
    the reference's ``_path_to_str``."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _port_flat(v, join(k))
    elif isinstance(specs, list) or (isinstance(specs, tuple) and specs and
                                     isinstance(specs[0], (dict, list))):
        for i, v in enumerate(specs):
            yield from _port_flat(v, join(i))
    else:
        yield path, specs


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "granite-moe-1b-a400m"])
def test_moe_specs_without_expert_parallelism_match(shapes, arch):
    mesh = mesh_single()
    r_mesh = _r_mesh(mesh)
    r_leaves, p_params = shapes[arch]
    specs = param_shardings(p_params, mesh, ep=False)
    for path, shape in r_leaves:
        want = tuple(r_sharding.spec_for_param(path, shape, r_mesh, ep=False))
        got = _port_leaf(specs, path)
        if path.split("/")[0] in STACKED:
            want = want[1:]
        assert all(g == want for g in got), (path, got[0], want)


@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
@pytest.mark.parametrize("batch", [256, 3])
def test_batch_and_embeds_specs_match(mesh_fn, batch):
    mesh = mesh_fn()
    r_mesh = _r_mesh(mesh)
    for ndim in (1, 2):
        assert batch_sharding(mesh, batch, ndim) == \
            tuple(r_sharding.batch_sharding(r_mesh, batch, ndim).spec)
    assert embeds_sharding(mesh, batch) == \
        tuple(r_sharding.embeds_sharding(r_mesh, batch).spec)


@pytest.mark.parametrize("arch,batch,max_len", [
    ("qwen2-1.5b", 128, 512), ("zamba2-1.2b", 128, 512),
    ("zamba2-1.2b", 1, 4096), ("xlstm-350m", 1, 64),
    ("seamless-m4t-large-v2", 128, 256), ("llama3-405b", 1, 4096)])
@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
def test_cache_specs_match(arch, batch, max_len, mesh_fn):
    """The caches keep the reference's stacked layout in the port, so the
    rule gives the same spec for every cache tensor."""
    mesh = mesh_fn()
    r_mesh = _r_mesh(mesh)
    r_model = r_build(r_get_config(arch))
    cfg = get_config(arch)
    r_cache = jax.eval_shape(lambda: r_model.init_cache(batch, max_len))
    want = jax.tree.map(lambda s: tuple(s.spec), r_sharding.cache_shardings(
        r_cache, r_mesh, batch, r_model.cfg))
    cache = build(cfg).init_cache(batch, max_len, device="meta")
    got = cache_shardings(cache, mesh, batch, cfg)
    flat_want = {r_sharding._path_to_str(path): spec for path, spec in
                 jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert dict(_port_flat(got)) == flat_want


def test_state_specs_follow_the_params_and_fit_the_host_mesh():
    """Adam's moments take the params' specs; on the one-device host mesh
    every spec is realisable, and a spec that names an axis the mesh
    lacks, or a dimension it cannot split, is refused."""
    with runtime.use_device("cpu"):
        mesh = p_mesh.host_mesh()
        model = build(get_config("qwen2-1.5b"))
        state = init_state(model, 0, device="meta")
        specs = state_shardings(state, mesh)
        assert specs.opt.mu == specs.params == specs.opt.nu
        assert specs.opt.step == ()
        n = check_realisable(specs, state, mesh)
        assert n == 3 * (28 * 12 + 2) + 1
        prod = state_shardings(state, mesh_single())
        with pytest.raises(ValueError, match="not on the mesh"):
            check_realisable(prod, state, p_mesh.make_mesh((1,), ("x",)))
        with pytest.raises(ValueError, match="split"):
            check_realisable({"w": ("data",)}, {"w": torch.zeros(3)},
                             p_mesh.make_mesh((2, 1)))
