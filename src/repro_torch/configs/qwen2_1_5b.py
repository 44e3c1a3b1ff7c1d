"""qwen2-1.5b [arXiv:2407.10671; hf] — GQA kv=2, QKV bias."""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
        vocab_size=151936, qkv_bias=True, tie_embeddings=True,
        source="arXiv:2407.10671; hf")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen2-1.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, qkv_bias=True, tie_embeddings=True,
        param_dtype="float32", remat=False)
