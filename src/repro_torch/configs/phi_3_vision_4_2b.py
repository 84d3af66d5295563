"""phi-3-vision-4.2b [vlm] — 32L d=3072 32H d_ff=8192 vocab=32064;
phi3-mini backbone + CLIP frontend STUB: input_specs() provides
precomputed patch embeddings (B, 256, 1024), projected and prepended to
the token sequence. [hf:microsoft/Phi-3-vision-128k-instruct]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="transformer",
        vocab=32064, d_model=3072, n_layers=32,
        n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192,
        patch_input=True, n_patches=256, patch_dim=1024,
        rope_theta=1e4, max_seq=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke",
        family="transformer",
        vocab=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=192,
        patch_input=True, n_patches=8, patch_dim=32,
        max_seq=256,
    )
