"""rwkv6-3b "Finch" [ssm] — 32L d=2560 attn-free, d_ff=8960,
vocab=65536, data-dependent decay, head size 64. [arXiv:2404.05892]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="rwkv6",
        vocab=65536, d_model=2560, n_layers=32,
        d_ff=8960,
        ssm_heads=40,                    # head size 64
        max_seq=1 << 20,                 # state-based: unbounded context
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="rwkv6",
        vocab=512, d_model=64, n_layers=2,
        d_ff=192,
        ssm_heads=4,
        max_seq=512,
    )
