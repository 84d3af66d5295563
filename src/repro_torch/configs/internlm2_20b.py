"""internlm2-20b [dense] — 48L d=6144 48H (GQA kv=8) d_ff=16384,
vocab=92544. [arXiv:2403.17297]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="transformer",
        vocab=92544, d_model=6144, n_layers=48,
        n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384,
        rope_theta=1e6, max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke",
        family="transformer",
        vocab=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192,
        max_seq=256,
    )
