"""Architecture + run configuration system (the port's copy of the
reference's ``configs/base.py``; ``pdtype``/``cdtype`` return torch dtypes).

One ``ArchConfig`` per assigned architecture (see siblings in this package)
with the exact published hyper-parameters, plus ``smoke()`` reduced
variants for CPU tests.  Shapes are the four assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A model architecture; families: dense|moe|ssm|hybrid|audio|vlm."""

    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0                     # mamba2 state size N
    ssm_expand: int = 2                    # d_inner = expand * d_model
    ssm_chunk: int = 128                   # SSD chunk length
    #: hybrid (zamba2): apply the shared attention block every k-th layer
    shared_attn_every: int = 0
    #: xlstm: every k-th layer is an sLSTM block (rest mLSTM); 0 = all mLSTM
    slstm_every: int = 0
    #: enc-dec (seamless): number of encoder layers (decoder = n_layers)
    n_encoder_layers: int = 0
    #: vlm (pixtral): number of prepended image-patch embeddings
    n_patches: int = 0
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    max_seq: int = 1 << 20
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    #: "xla" = the plain chunked online-softmax in PyTorch (name kept from
    #: the reference); "flash" = kernel K5 on CUDA tensors (its plain
    #: attention_ref on CPU tensors)
    attn_impl: str = "xla"
    #: fully unroll layer scans (dry-run cost probes — XLA's cost_analysis
    #: counts while bodies once, so probes must not use while loops)
    scan_unroll: bool = False
    #: notes on published-source + verification tier
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state => long_500k applies (ssm/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def pdtype(self):
        return _DTYPES[self.param_dtype]

    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    def n_params(self) -> float:
        """Approximate total parameter count (embedding included)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + \
            self.n_heads * hd * d
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * f + d * self.moe.n_experts
        elif self.family == "ssm":
            d_in = self.ssm_expand * d
            ffn = 0.0
            attn = 2 * d * d_in + 2 * d * self.ssm_state * 2 + d_in * d
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        total = L * per_layer + 2 * self.vocab_size * d
        if self.is_encdec:
            total += self.n_encoder_layers * per_layer
        return float(total)

    def n_active_params(self) -> float:
        """Active params per token (MoE counts top-k experts only)."""
        if not self.moe:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + \
            self.n_heads * hd * d
        ffn = self.moe.top_k * 3 * d * f + d * self.moe.n_experts
        return float(L * (attn + ffn + 2 * d) + 2 * self.vocab_size * d)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applies(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a shape cell applies to an arch (with skip reason)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: O(L^2) attention at 512k "
                       "has no published sub-quadratic variant — skipped "
                       "per assignment note")
    return True, ""


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run hyper-parameters (launcher-level)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
    microbatch: int = 0          # 0 = no gradient accumulation
    #: cast gradients to bf16 before the cross-replica reduction (halves
    #: grad all-reduce/reduce-scatter bytes; clip + Adam math stay fp32)
    grad_compression: bool = False
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10
