"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small; hf] — Mamba2 and
NoPE GQA layers (9:1), each followed by 72 experts (top-10) and a shared
expert, with Granite's muP multipliers.  A port-only architecture: the
JAX package has no twin, so it is not among ``ARCH_IDS``."""
from repro_torch.configs.base import ArchConfig, MoEConfig

#: the published ``layer_types``: attention at layers 5, 15, 25 and 35
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="granite-4.0-h-small", family="granite_hybrid",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=768,
        vocab_size=100352, tie_embeddings=True,
        moe=MoEConfig(n_experts=72, top_k=10), shared_expert_ff=1536,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        layer_types=LAYER_TYPES, rope=False, rope_theta=10000.0,
        embedding_multiplier=12.0, attention_multiplier=0.0078125,
        residual_multiplier=0.22, logits_scaling=16.0,
        param_dtype="bfloat16",
        source="hf:ibm-granite/granite-4.0-h-small; hf")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="granite-4.0-h-small-smoke", family="granite_hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab_size=256, tie_embeddings=True,
        moe=MoEConfig(n_experts=8, top_k=3), shared_expert_ff=48,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8,
        layer_types=("mamba", "attention", "mamba", "mamba"), rope=False,
        embedding_multiplier=12.0, attention_multiplier=0.0625,
        residual_multiplier=0.22, logits_scaling=16.0,
        param_dtype="float32", remat=False)
