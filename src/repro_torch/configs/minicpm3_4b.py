"""minicpm3-4b [dense] — 62L d=2560 40H, MLA (q_lora=768, kv_lora=256),
d_ff=6400, vocab=73448. [hf:openbmb/MiniCPM3-4B]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="transformer",
        vocab=73448, d_model=2560, n_layers=62,
        n_heads=40, n_kv_heads=40,
        attn="mla", q_lora=768, kv_lora=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
        d_ff=6400,
        rope_theta=1e4, max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke",
        family="transformer",
        vocab=512, d_model=64, n_layers=3,
        n_heads=4, n_kv_heads=4,
        attn="mla", q_lora=48, kv_lora=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        d_ff=192,
        max_seq=256,
    )
