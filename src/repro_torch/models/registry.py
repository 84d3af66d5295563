"""Model registry: ModelConfig.family -> model class."""
from __future__ import annotations

from repro_torch.models.common import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.family == "rwkv6":
        from repro_torch.models.rwkv6 import RWKV6Model
        return RWKV6Model(cfg)
    if cfg.family == "hymba":
        from repro_torch.models.hymba import HymbaModel
        return HymbaModel(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.transformer import EncDecModel
        return EncDecModel(cfg)
    from repro_torch.models.transformer import TransformerModel
    return TransformerModel(cfg)
