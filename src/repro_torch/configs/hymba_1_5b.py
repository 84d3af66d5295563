"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv=5) d_ff=5504,
vocab=32001, parallel attention + mamba(SSD) heads, ssm_state=16;
sliding-window attention except first/middle/last layers (global).
[arXiv:2411.13676]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hymba",
        vocab=32001, d_model=1600, n_layers=32,
        n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504,
        window=1024, global_layers=(0, 15, 31),
        ssm_heads=25, ssm_head_dim=64, ssm_state=16,
        rope_theta=1e4, max_seq=1 << 20,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hymba",
        vocab=512, d_model=64, n_layers=3,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192,
        window=16, global_layers=(0, 2),
        ssm_heads=4, ssm_head_dim=16, ssm_state=8,
        max_seq=512,
    )
