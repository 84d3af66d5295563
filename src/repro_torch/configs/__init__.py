"""The ten model architectures of the LM scaffold, as in the JAX
package's ``repro.configs``: each module exposes ``config()`` (the full
published size) and ``smoke_config()`` (the same family at reduced
widths, CPU-testable). ``--arch <id>`` strings of the launchers map to
modules here.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "deepseek_v2_lite_16b",
    "dbrx_132b",
    "rwkv6_3b",
    "minicpm3_4b",
    "internlm2_20b",
    "qwen2_5_3b",
    "gemma3_4b",
    "seamless_m4t_medium",
    "hymba_1_5b",
    "phi_3_vision_4_2b",
]


def _mod_name(arch_id: str) -> str:
    """Canonical dashed id (CLI) -> module name."""
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_mod_name(arch_id)}")
    return mod.smoke_config() if smoke else mod.config()


def all_arch_ids():
    return [a.replace("_", "-") for a in ARCHS]
