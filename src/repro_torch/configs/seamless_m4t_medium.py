"""seamless-m4t-medium [audio] — enc-dec, 12L encoder + 12L decoder,
d=1024 16H d_ff=4096 vocab=256206. The speech frontend is a STUB:
input_specs() provides precomputed frame embeddings (B, S, 1024).
[arXiv:2308.11596]
"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        vocab=256206, d_model=1024,
        n_layers=24, enc_layers=12, dec_layers=12,
        n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096,
        frame_input=True, frame_dim=1024,
        rope_theta=1e4, max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="encdec",
        vocab=512, d_model=64,
        n_layers=4, enc_layers=2, dec_layers=2,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=192,
        frame_input=True, frame_dim=32,
        max_seq=256,
    )
