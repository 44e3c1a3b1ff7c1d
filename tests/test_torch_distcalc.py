"""Port vs reference: the Distributed Data Calculator (``core/distcalc.py``).

Twins of the reference's five distcalc tests (``tests/test_train_infra.py``),
then the port held against the reference over all ten configs x the four
``SHAPES`` x three meshes, under the reference's ``TPU_V5E`` and the
card's ``H100_SXM`` figures.  Both packages do the same Python float
arithmetic in the same order, so every comparison is exact: ``==`` on
every ``RooflineTerms`` field, every ``invalid_reasons`` list, every
``fits_memory`` answer, every chosen ``Strategy`` and every
``what_if_mesh`` number.
"""
import dataclasses
import itertools
import math

import pytest

from repro.configs import get_config as r_get_config
from repro.configs.base import SHAPES as R_SHAPES
from repro.core import distcalc as r_distcalc
from repro.core.hardware import TPUProfile as RTPUProfile
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import distcalc
from repro_torch.core.hardware import H100_SXM, TPU_V5E, TPUProfile

#: the same figures as the reference's class, so its functions take them
R_H100 = RTPUProfile(**dataclasses.asdict(H100_SXM))
PROFILES = {"tpu_v5e": (TPU_V5E, r_distcalc.TPU_V5E),
            "h100_sxm": (H100_SXM, R_H100)}
MESHES = {"16x16": dict(), "2x16x16": dict(pods=2),
          "one_chip": dict(data=1, model=1, pods=1)}


# ---------------------------------------------------------------------------
# twins of the reference's distcalc tests
# ---------------------------------------------------------------------------
def test_distcalc_invalidation_rules():
    cfg = get_config("qwen2-1.5b")
    shape = SHAPES["train_4k"]
    mesh = distcalc.MeshSpec()
    bad_tp = distcalc.Strategy(tp=32)
    assert distcalc.invalid_reasons(cfg, shape, mesh, bad_tp)
    bad_ep = distcalc.Strategy(tp=1, ep=True)
    assert any("MoE" in e for e in
               distcalc.invalid_reasons(cfg, shape, mesh, bad_ep))


def test_distcalc_terms_positive_and_fsdp_saves_memory():
    cfg = get_config("llama3-405b")
    shape = SHAPES["train_4k"]
    mesh = distcalc.MeshSpec()
    fsdp = distcalc.synthesize(cfg, shape, mesh,
                               distcalc.Strategy(tp=16, fsdp=True, ep=False))
    dp = distcalc.synthesize(cfg, shape, mesh,
                             distcalc.Strategy(tp=16, fsdp=False, ep=False))
    for terms in (fsdp, dp):
        assert terms.compute_s > 0 and terms.memory_s > 0
    assert fsdp.hbm_bytes_per_chip < dp.hbm_bytes_per_chip


def test_distcalc_autocomplete_returns_fitting_strategy():
    cfg = get_config("llama3-405b")
    shape = SHAPES["train_4k"]
    mesh = distcalc.MeshSpec(pods=2)
    strat, terms = distcalc.complete_strategy(cfg, shape, mesh)
    assert distcalc.fits_memory(cfg, shape, mesh, strat)
    assert terms.step_seconds > 0


def test_distcalc_what_if_more_pods_speeds_up_compute_bound():
    cfg = get_config("qwen1.5-32b")
    shape = SHAPES["train_4k"]
    out = distcalc.what_if_mesh(cfg, shape, distcalc.MeshSpec(pods=1),
                                distcalc.MeshSpec(pods=2))
    assert out["variant_step_s"] <= out["base_step_s"] * 1.05


def test_distcalc_moe_uses_ep():
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    shape = SHAPES["train_4k"]
    strat, _ = distcalc.complete_strategy(cfg, shape, distcalc.MeshSpec())
    assert strat.ep


# ---------------------------------------------------------------------------
# the H100 profile
# ---------------------------------------------------------------------------
def test_h100_profile_is_the_datasheet_figures():
    """An instance of the reference's class with the card's peaks:
    989 TFLOP/s bf16, 3.35 TB/s, 80 GB, NVLink 450 GB/s a direction;
    ``TPU_V5E`` is the reference's, field for field."""
    assert isinstance(H100_SXM, TPUProfile)
    assert (H100_SXM.peak_flops_bf16, H100_SXM.hbm_bw, H100_SXM.hbm_bytes,
            H100_SXM.ici_bw) == (989e12, 3.35e12, 80e9, 450e9)
    assert dataclasses.asdict(TPU_V5E) == \
        dataclasses.asdict(r_distcalc.TPU_V5E)
    assert H100_SXM.compute_seconds(989e12) == 1.0
    assert H100_SXM.memory_seconds(3.35e12) == 1.0
    assert H100_SXM.collective_seconds(450e9) == 1.0


def test_one_chip_train_prediction_of_qwen2():
    """qwen2-1.5b's train step at 4 x 2,048 on one H100 with the card
    run's strategy: compute-bound at 1.07e14 FLOPs; the one-chip mesh
    still charges the gradient all-reduce, as the reference does
    (``2 N pb / tp``, whatever ``dp`` is); remat off is predicted faster
    and fits."""
    cfg = get_config("qwen2-1.5b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=2048,
                                global_batch=4)
    mesh = distcalc.MeshSpec(1, 1, 1)
    strat = distcalc.Strategy(tp=1, fsdp=False, ep=False, remat=True)
    terms = distcalc.synthesize(cfg, shape, mesh, strat, H100_SXM)
    assert terms.dominant == "compute"
    assert terms.step_seconds == terms.compute_s
    assert terms.collective_bytes_per_chip == 2 * cfg.n_params() * 4
    assert math.isclose(terms.flops_per_chip, 1.0693e14, rel_tol=1e-4)
    best, best_terms = distcalc.complete_strategy(cfg, shape, mesh,
                                                  tpu=H100_SXM)
    assert best == dataclasses.replace(strat, remat=False)
    assert best_terms.step_seconds < terms.step_seconds
    assert distcalc.fits_memory(cfg, shape, mesh, best, H100_SXM)


# ---------------------------------------------------------------------------
# port vs reference, exact, over the whole sweep
# ---------------------------------------------------------------------------
def _terms(t):
    return (t.compute_s, t.memory_s, t.collective_s, t.flops_per_chip,
            t.hbm_bytes_per_chip, t.collective_bytes_per_chip,
            t.model_flops, t.dominant, t.step_seconds, t.roofline_fraction)


def _all_strategies(mesh):
    """Every strategy the invalidation rules can tell apart on ``mesh``:
    valid and invalid, with and without microbatches."""
    for tp, fsdp, ep, sp, remat, mb in itertools.product(
            sorted({1, 2, mesh.model, 32}), (False, True), (False, True),
            (False, True), (False, True), (1, 3)):
        yield dict(tp=tp, fsdp=fsdp, ep=ep, sp=sp, remat=remat,
                   microbatches=mb)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_distcalc_matches_reference_exactly(arch, shape_name, mesh_name):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    shape, r_shape = SHAPES[shape_name], R_SHAPES[shape_name]
    mesh = distcalc.MeshSpec(**MESHES[mesh_name])
    r_mesh = r_distcalc.MeshSpec(**MESHES[mesh_name])
    assert mesh.chips == r_mesh.chips
    assert distcalc.forward_flops(cfg, shape) == \
        r_distcalc.forward_flops(r_cfg, r_shape)
    assert distcalc.model_flops(cfg, shape) == \
        r_distcalc.model_flops(r_cfg, r_shape)
    for kw in _all_strategies(mesh):
        strat, r_strat = distcalc.Strategy(**kw), r_distcalc.Strategy(**kw)
        assert strat.describe() == r_strat.describe()
        assert distcalc.invalid_reasons(cfg, shape, mesh, strat) == \
            r_distcalc.invalid_reasons(r_cfg, r_shape, r_mesh, r_strat), kw
    cands = distcalc.candidate_strategies(cfg, shape, mesh)
    r_cands = r_distcalc.candidate_strategies(r_cfg, r_shape, r_mesh)
    assert [dataclasses.astuple(s) for s in cands] == \
        [dataclasses.astuple(s) for s in r_cands]
    for name, (tpu, r_tpu) in PROFILES.items():
        for strat, r_strat in zip(cands, r_cands):
            got = distcalc.synthesize(cfg, shape, mesh, strat, tpu)
            want = r_distcalc.synthesize(r_cfg, r_shape, r_mesh, r_strat,
                                         r_tpu)
            assert _terms(got) == _terms(want), (name, strat)
            assert got.to_json() == want.to_json()
            assert distcalc.fits_memory(cfg, shape, mesh, strat, tpu) == \
                r_distcalc.fits_memory(r_cfg, r_shape, r_mesh, r_strat,
                                       r_tpu), (name, strat)
        best, terms = distcalc.complete_strategy(cfg, shape, mesh, tpu=tpu)
        r_best, r_terms = r_distcalc.complete_strategy(r_cfg, r_shape,
                                                       r_mesh, tpu=r_tpu)
        assert dataclasses.astuple(best) == dataclasses.astuple(r_best), name
        assert _terms(terms) == _terms(r_terms), name
        for partial in ({"remat": True}, {"fsdp": False}, {"tp": 1}):
            best, terms = distcalc.complete_strategy(cfg, shape, mesh,
                                                     partial, tpu)
            r_best, r_terms = r_distcalc.complete_strategy(
                r_cfg, r_shape, r_mesh, partial, r_tpu)
            assert dataclasses.astuple(best) == \
                dataclasses.astuple(r_best), (name, partial)
            assert _terms(terms) == _terms(r_terms), (name, partial)
    for variant in MESHES.values():
        assert distcalc.what_if_mesh(
            cfg, shape, mesh, distcalc.MeshSpec(**variant)) == \
            r_distcalc.what_if_mesh(r_cfg, r_shape, r_mesh,
                                    r_distcalc.MeshSpec(**variant))
