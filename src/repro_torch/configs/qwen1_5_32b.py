"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B family; hf] — QKV bias, MHA kv=40."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
        vocab_size=152064, qkv_bias=True, param_dtype="bfloat16",
        source="hf:Qwen/Qwen1.5-0.5B; hf")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen1.5-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, qkv_bias=True, param_dtype="float32", remat=False)
