"""zamba2-1.2b [arXiv:2411.15242; hf] — Mamba2 backbone + shared attn block."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=32000, ssm_state=64, ssm_expand=2, shared_attn_every=6,
        source="arXiv:2411.15242; hf")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="zamba2-1.2b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, ssm_state=16, ssm_expand=2, shared_attn_every=2,
        param_dtype="float32", remat=False)
