"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified].

Backbone only (mistral-nemo style decoder, head_dim 160, GQA kv=8); the
pixtral-ViT frontend is a stub — ``input_specs`` provides precomputed patch
embeddings prepended to the token sequence.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=131072, head_dim=160, n_patches=256,
        param_dtype="bfloat16",
        source="hf:mistralai/Pixtral-12B-2409; unverified")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="pixtral-12b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, n_patches=8, param_dtype="float32",
        remat=False)
