"""xlstm-350m [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

d_ff=0 per the assignment: blocks carry their own up/down projections
(mLSTM projection factor 2) rather than a separate FFN.  Every 4th block is
an sLSTM (scalar memory, sequential scan); the rest are mLSTM (matrix
memory, chunked-parallel) — the paper's mixed-block configuration.
"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304, ssm_state=0, ssm_expand=2, slstm_every=4,
        source="arXiv:2405.04517; unverified")


def smoke() -> ArchConfig:
    return ArchConfig(
        arch_id="xlstm-350m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
        vocab_size=256, ssm_state=0, ssm_expand=2, slstm_every=2,
        param_dtype="float32", remat=False)
