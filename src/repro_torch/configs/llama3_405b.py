"""llama3-405b [arXiv:2407.21783; unverified] — GQA kv=8, 128k vocab."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
        vocab_size=128256, head_dim=128, param_dtype="bfloat16",
        rope_theta=5e5, source="arXiv:2407.21783; unverified")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="llama3-405b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab_size=256, head_dim=16, param_dtype="float32", remat=False)
