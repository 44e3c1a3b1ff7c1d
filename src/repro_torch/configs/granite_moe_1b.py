"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
        vocab_size=49155, moe=MoEConfig(n_experts=32, top_k=8),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="granite-moe-1b-a400m-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab_size=256, moe=MoEConfig(n_experts=8, top_k=4),
        param_dtype="float32", remat=False)
