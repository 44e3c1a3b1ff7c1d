"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B; hf] — qwen1.5 arch, MHA."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
        vocab_size=92416, qkv_bias=True, param_dtype="bfloat16",
        source="hf:Qwen/CodeQwen1.5-7B; hf")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="codeqwen1.5-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256, qkv_bias=True, param_dtype="float32", remat=False)
