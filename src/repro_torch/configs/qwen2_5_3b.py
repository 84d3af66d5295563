"""qwen2.5-3b [dense] — 36L d=2048 16H (GQA kv=2) d_ff=11008,
vocab=151936, QKV bias. [hf:Qwen/Qwen2.5-3B]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="transformer",
        vocab=151936, d_model=2048, n_layers=36,
        n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e6, max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="transformer",
        vocab=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, qkv_bias=True,
        tie_embeddings=True,
        max_seq=256,
    )
