"""The Distributed Data Calculator: the paper's paradigm applied to the
distributed-layout design space of a training/serving step (the port of
``repro/core/distcalc.py``).

Mapping:

* layout primitives  -> per-tensor sharding decisions (TP/FSDP/EP/SP axes)
  with invalidation rules = divisibility + mesh-axis reuse;
* access primitives  -> matrix-unit compute, HBM read/write, interconnect
  collectives, each with a parametric cost model over (bytes, axis size,
  bandwidth);
* cost synthesis     -> the three roofline terms per (arch x shape x mesh x
  strategy), computed without compiling anything;
* what-if            -> re-cost under a different mesh/strategy/hardware;
* auto-completion    -> Algorithm-1-style search completing a partial
  sharding strategy, ranking by synthesized step time.

Plain Python float arithmetic, every expression in the reference's order,
so both packages give the same terms bit for bit.  The default chip is the
reference's ``TPU_V5E``; a caller on an H100 passes
``repro_torch.core.hardware.H100_SXM``.  ``chip_smoke.py`` holds the
predicted step times against the ones it measures on the card (the
paper's Fig. 6 predicted-vs-implemented method).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.hardware import TPUProfile, TPU_V5E


# ---------------------------------------------------------------------------
# Sharding strategy = the "element" of the distributed design space
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Strategy:
    """One point in the distributed-layout space (per arch x mesh)."""

    tp: int = 16          # model-axis ways used for tensor parallelism
    fsdp: bool = True     # ZeRO-3 params over the data axis (within pod)
    ep: bool = True       # expert parallelism over the model axis (MoE)
    sp: bool = False      # sequence(context) parallelism for caches
    remat: bool = True    # full activation rematerialization
    microbatches: int = 1

    def describe(self) -> str:
        bits = [f"tp{self.tp}", "fsdp" if self.fsdp else "dp",
                "remat" if self.remat else "norem"]
        if self.ep:
            bits.append("ep")
        if self.sp:
            bits.append("sp")
        if self.microbatches > 1:
            bits.append(f"mb{self.microbatches}")
        return "+".join(bits)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pods


def invalid_reasons(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
                    strategy: Strategy) -> List[str]:
    """Invalidation rules (the distributed analogue of Figure 11's rules)."""
    errors = []
    if strategy.tp > mesh.model:
        errors.append(f"tp={strategy.tp} exceeds model axis {mesh.model}")
    if strategy.tp > 1:
        hd = cfg.resolved_head_dim
        if cfg.n_heads % strategy.tp and hd % strategy.tp and \
                (cfg.d_ff % strategy.tp if cfg.d_ff else True):
            errors.append("no shardable attention/mlp dim for tp")
    if strategy.ep and not cfg.moe:
        errors.append("ep requires MoE")
    if strategy.ep and cfg.moe and cfg.moe.n_experts % mesh.model:
        errors.append("experts not divisible by model axis")
    dp = mesh.data * mesh.pods
    if shape.kind == "train" and shape.global_batch % \
            (dp * max(strategy.microbatches, 1)):
        errors.append("global batch not divisible by dp x microbatches")
    return errors


# ---------------------------------------------------------------------------
# Access-primitive cost synthesis (per training/serving step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_seconds(self) -> float:
        # perfect overlap bound: the step cannot run faster than max(term)
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute seconds / bound = how close to the compute roof."""
        if self.step_seconds <= 0:
            return 0.0
        return self.compute_s / self.step_seconds

    def to_json(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "flops_per_chip": self.flops_per_chip,
                "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
                "collective_bytes_per_chip": self.collective_bytes_per_chip,
                "model_flops": self.model_flops,
                "dominant": self.dominant,
                "step_seconds": self.step_seconds}


def _dtype_bytes(cfg: ArchConfig) -> Tuple[int, int]:
    pb = 2 if cfg.param_dtype == "bfloat16" else 4
    cb = 2 if cfg.compute_dtype == "bfloat16" else 4
    return pb, cb


def _attention_flops(cfg: ArchConfig, tokens: float, context: float) -> float:
    """Per-layer attention FLOPs for `tokens` queries over `context` keys."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    proj = 2 * tokens * d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + \
        2 * tokens * cfg.n_heads * hd * d
    scores = 4 * tokens * context * cfg.n_heads * hd
    return proj + scores


def _ffn_flops(cfg: ArchConfig, tokens: float) -> float:
    if cfg.moe:
        return 2 * tokens * cfg.moe.top_k * 3 * cfg.d_model * cfg.d_ff + \
            2 * tokens * cfg.d_model * cfg.moe.n_experts
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        # up/down projections + state update ~ 2*d_in*state per token
        return 2 * tokens * (3 * cfg.d_model * d_in +
                             d_in * max(cfg.ssm_state, 256))
    return 2 * tokens * 3 * cfg.d_model * cfg.d_ff


def _ssm_flops(cfg: ArchConfig, tokens: float) -> float:
    d_in = cfg.ssm_expand * cfg.d_model
    n = max(cfg.ssm_state, 64)
    cl = cfg.ssm_chunk
    # intra-chunk quadratic + state build/apply (chunked SSD)
    return 2 * tokens * (2 * cfg.d_model * d_in + d_in * cfg.d_model) + \
        2 * tokens * cl * (d_in + 2 * n) + 4 * tokens * d_in * n


def forward_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Forward FLOPs for one step of this shape (whole cluster)."""
    if shape.kind == "decode":
        tokens = float(shape.global_batch)          # one token per sequence
        context = float(shape.seq_len)
    else:
        tokens = float(shape.global_batch * shape.seq_len)
        context = float(shape.seq_len) / 2          # causal average
    per_layer = 0.0
    if cfg.family in ("dense", "moe", "vlm"):
        per_layer = _attention_flops(cfg, tokens, context) + \
            _ffn_flops(cfg, tokens)
        total = cfg.n_layers * per_layer
    elif cfg.family == "ssm":
        total = cfg.n_layers * _ssm_flops(cfg, tokens)
    elif cfg.family == "hybrid":
        n_attn = (cfg.n_layers + cfg.shared_attn_every - 1) // \
            max(cfg.shared_attn_every, 1)
        total = cfg.n_layers * _ssm_flops(cfg, tokens) + \
            n_attn * (_attention_flops(cfg, tokens, context) +
                      _ffn_flops(cfg, tokens))
    elif cfg.family == "audio":
        src_tokens = tokens if shape.kind != "decode" else \
            float(shape.global_batch * 4096)
        enc = cfg.n_encoder_layers * (
            _attention_flops(cfg, src_tokens, context) +
            _ffn_flops(cfg, src_tokens))
        dec = cfg.n_layers * (
            _attention_flops(cfg, tokens, context) * 2 +   # self + cross
            _ffn_flops(cfg, tokens))
        if shape.kind == "decode":
            enc = 0.0  # encoder output cached
        total = enc + dec
    else:
        raise ValueError(cfg.family)
    # unembedding
    total += 2 * tokens * cfg.d_model * cfg.vocab_size
    return total


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) — the §Roofline 'useful' FLOPs."""
    if shape.kind == "decode":
        tokens = float(shape.global_batch)
    else:
        tokens = float(shape.global_batch * shape.seq_len)
    n = cfg.n_active_params()
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n * tokens


def synthesize(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
               strategy: Strategy, tpu: TPUProfile = TPU_V5E
               ) -> RooflineTerms:
    """Cost synthesis: the three roofline terms for one step."""
    chips = mesh.chips
    pb, cb = _dtype_bytes(cfg)
    fwd = forward_flops(cfg, shape)
    flops = fwd * (3.0 if shape.kind == "train" else 1.0)
    if shape.kind == "train" and strategy.remat:
        flops += fwd  # recompute forward during backward
    flops_per_chip = flops / chips

    # ---- HBM traffic -------------------------------------------------------
    n_params = cfg.n_params()
    dp = mesh.data * mesh.pods
    param_shard = n_params / (dp if strategy.fsdp else 1) / strategy.tp
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    act_bytes_per_chip = tokens * cfg.d_model * cb * \
        (12 if shape.kind == "train" else 2) / chips
    if shape.kind == "train":
        # params: fwd read + bwd read + update rw; grads w+r; moments 2r+2w
        hbm = n_params / strategy.tp / (dp if strategy.fsdp else 1) * (
            3 * pb + 2 * pb + 4 * 4)
        hbm = hbm + act_bytes_per_chip
        # gathered FSDP params stream through HBM once per layer pass
        if strategy.fsdp:
            hbm += 2 * n_params / strategy.tp * pb / mesh.data
    else:
        hbm = n_params / chips * pb if strategy.fsdp else \
            n_params / strategy.tp * pb / (1 if shape.kind == "decode"
                                           else 1)
        # KV/state cache read+write
        if cfg.family in ("dense", "moe", "vlm", "audio"):
            kv = (cfg.n_layers * 2 * shape.seq_len * shape.global_batch *
                  cfg.n_kv_heads * cfg.resolved_head_dim * cb)
            hbm += (2 * kv if shape.kind == "decode" else kv) / chips
        else:
            d_in = cfg.ssm_expand * cfg.d_model
            state = cfg.n_layers * shape.global_batch * d_in * \
                max(cfg.ssm_state, d_in // max(cfg.n_heads, 1)) * 4
            hbm += 2 * state / chips
        hbm += act_bytes_per_chip
    hbm_per_chip = hbm

    # ---- collectives -------------------------------------------------------
    coll = 0.0
    if shape.kind == "train":
        if strategy.fsdp:
            # all-gather params fwd + bwd, reduce-scatter grads (per chip,
            # ring: bytes ~ full shard-group size)
            coll += 3 * (n_params / strategy.tp) * pb / mesh.data * \
                (mesh.data - 1)
        else:
            coll += 2 * (n_params / strategy.tp) * pb  # grad all-reduce
        if mesh.pods > 1:
            coll += 2 * (n_params / strategy.tp / mesh.data) * pb
        if strategy.tp > 1:
            # Megatron: 2 all-reduces per block per microbatch pass x3 passes
            blocks = cfg.n_layers * (2 if cfg.family != "ssm" else 1)
            coll += 3 * 2 * blocks * tokens * cfg.d_model * cb / \
                (chips / strategy.tp) * 2 / strategy.tp * (strategy.tp - 1)
        if cfg.moe and strategy.ep:
            coll += 3 * 2 * cfg.n_layers * tokens * cfg.moe.top_k * \
                cfg.d_model * cb / chips
    else:
        if strategy.tp > 1:
            blocks = cfg.n_layers * (2 if cfg.family != "ssm" else 1)
            coll += 2 * blocks * tokens * cfg.d_model * cb / \
                (chips / strategy.tp) * 2 / strategy.tp * (strategy.tp - 1)
        if cfg.moe and strategy.ep:
            coll += 2 * cfg.n_layers * tokens * cfg.moe.top_k * \
                cfg.d_model * cb / chips
        if strategy.fsdp:
            coll += n_params / strategy.tp * pb / mesh.data * \
                (mesh.data - 1) / max(tokens / shape.global_batch, 1)
    coll_per_chip = coll

    return RooflineTerms(
        compute_s=flops_per_chip / tpu.peak_flops_bf16,
        memory_s=hbm_per_chip / tpu.hbm_bw,
        collective_s=coll_per_chip / tpu.ici_bw,
        flops_per_chip=flops_per_chip,
        hbm_bytes_per_chip=hbm_per_chip,
        collective_bytes_per_chip=coll_per_chip,
        model_flops=model_flops(cfg, shape))


# ---------------------------------------------------------------------------
# What-if + auto-completion over strategies (paper §4 transferred)
# ---------------------------------------------------------------------------
def candidate_strategies(cfg: ArchConfig, shape: ShapeConfig,
                         mesh: MeshSpec) -> List[Strategy]:
    out = []
    for tp, fsdp, remat in itertools.product(
            (1, mesh.model), (False, True), (False, True)):
        s = Strategy(tp=tp, fsdp=fsdp, ep=bool(cfg.moe), remat=remat,
                     sp=shape.name == "long_500k")
        if not invalid_reasons(cfg, shape, mesh, s):
            out.append(s)
    return out


def fits_memory(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
                strategy: Strategy, tpu: TPUProfile = TPU_V5E) -> bool:
    pb, cb = _dtype_bytes(cfg)
    n_params = cfg.n_params()
    dp = mesh.data * mesh.pods
    shard = n_params / strategy.tp / (dp if strategy.fsdp else 1)
    resident = shard * (pb + (pb + 8 if shape.kind == "train" else 0))
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len / mesh.chips
        act = tokens * cfg.d_model * cb * \
            (2 * cfg.n_layers if not strategy.remat else 4)
        resident += act
    else:
        kv = (cfg.n_layers * 2 * shape.seq_len * shape.global_batch *
              cfg.n_kv_heads * cfg.resolved_head_dim * cb) / mesh.chips
        resident += kv
    return resident < 0.9 * tpu.hbm_bytes


def complete_strategy(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshSpec,
                      partial: Optional[Dict] = None,
                      tpu: TPUProfile = TPU_V5E
                      ) -> Tuple[Strategy, RooflineTerms]:
    """Algorithm-1 analogue: fix the fields in ``partial``, search the rest,
    rank by synthesized step time subject to the memory-fit rule."""
    partial = partial or {}
    best: Optional[Tuple[Strategy, RooflineTerms]] = None
    for strat in candidate_strategies(cfg, shape, mesh):
        if any(getattr(strat, k) != v for k, v in partial.items()):
            continue
        if not fits_memory(cfg, shape, mesh, strat, tpu):
            continue
        terms = synthesize(cfg, shape, mesh, strat, tpu)
        if best is None or terms.step_seconds < best[1].step_seconds:
            best = (strat, terms)
    if best is None:  # nothing fits: fall back to max sharding
        strat = Strategy(tp=mesh.model, fsdp=True, ep=bool(cfg.moe))
        best = (strat, synthesize(cfg, shape, mesh, strat, tpu))
    return best


def what_if_mesh(cfg: ArchConfig, shape: ShapeConfig, base: MeshSpec,
                 variant: MeshSpec) -> Dict[str, float]:
    """E.g. 'what if we double the pods?' without touching a TPU."""
    _, t0 = complete_strategy(cfg, shape, base)
    _, t1 = complete_strategy(cfg, shape, variant)
    return {"base_step_s": t0.step_seconds, "variant_step_s": t1.step_seconds,
            "speedup": t0.step_seconds / max(t1.step_seconds, 1e-12)}
