"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — enc-dec, multimodal.

Backbone only: the speech/text frontend is a stub; ``input_specs`` feeds
precomputed frame embeddings to the 24L encoder, and the 24L decoder
cross-attends to encoder output.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
        vocab_size=256206, n_encoder_layers=24,
        source="arXiv:2308.11596; hf")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="seamless-m4t-large-v2-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, n_encoder_layers=2, param_dtype="float32",
        remat=False)
