"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, 64 routed experts
top-6 + 2 shared, first layer dense FFN (d_ff 10944). [arXiv:2405.04434]
(The assignment sheet's bracket note "160 routed" belongs to the full
V2; the lite config above matches the published HF config.)
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="transformer",
        vocab=102400, d_model=2048, n_layers=27,
        n_heads=16, n_kv_heads=16, head_dim=128,
        attn="mla", q_lora=0, kv_lora=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        d_ff=10944,
        moe=True, n_experts=64, n_shared=2, top_k=6, d_expert=1408,
        first_dense=1, d_ff_dense=10944,
        rope_theta=1e4, max_seq=163840,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        family="transformer",
        vocab=512, d_model=64, n_layers=3,
        n_heads=4, n_kv_heads=4, head_dim=16,
        attn="mla", q_lora=0, kv_lora=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        d_ff=192,
        moe=True, n_experts=8, n_shared=2, top_k=2, d_expert=48,
        first_dense=1, d_ff_dense=192,
        max_seq=256,
    )
