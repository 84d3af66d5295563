"""dbrx-132b [moe] — 40L d=6144 48H (GQA kv=8) d_ff=10752/expert,
16 experts top-4, vocab=100352. [hf:databricks/dbrx-base]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="transformer",
        vocab=100352, d_model=6144, n_layers=40,
        n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752,
        moe=True, n_experts=16, n_shared=0, top_k=4, d_expert=10752,
        rope_theta=5e5, max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke",
        family="transformer",
        vocab=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128,
        moe=True, n_experts=4, n_shared=0, top_k=2, d_expert=128,
        max_seq=256,
    )
