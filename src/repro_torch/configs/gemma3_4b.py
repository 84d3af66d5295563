"""gemma3-4b [dense] — 34L d=2560 8H (GQA kv=4) d_ff=10240,
vocab=262144, 5:1 local:global sliding-window (1024), 128k context.
[hf:google/gemma-3-4b-pt]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="transformer",
        vocab=262144, d_model=2560, n_layers=34,
        n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240,
        window=1024, global_every=6,      # layers 5, 11, ... are global
        tie_embeddings=True,
        rope_theta=1e6, max_seq=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="transformer",
        vocab=512, d_model=64, n_layers=6,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192,
        window=16, global_every=3,
        tie_embeddings=True,
        max_seq=256,
    )
