"""Token batch pipeline: synthetic shards + modality stubs + input_specs.

The port of ``repro.data.tokens``. ``make_batch`` draws from the same
numpy generator as the reference (so both packages get the same
arrays) and returns tensors on ``device``; ``input_specs`` returns
``meta`` tensors with identical structure (shapes and dtypes, no
allocation).

The pipeline is deterministic per (seed, step): a restarted job replays
or skips ahead without coordination.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._num import resolve_device
from repro_torch.models.common import ModelConfig


def _token_seq_len(cfg: ModelConfig, seq: int) -> int:
    """Text tokens after reserving room for modality stubs."""
    if cfg.patch_input:
        return seq - cfg.n_patches
    return seq


def _arrays(cfg: ModelConfig, batch: int, seq: int, seed: int,
            step: int) -> dict:
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003 + step)
    st = _token_seq_len(cfg, seq)
    out = {}
    if cfg.family == "encdec":
        # seq applies to the SOURCE frames; target is seq//8 (min 32)
        tgt = max(seq // 8, 32)
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.frame_dim), np.float32)
        out["frame_len"] = np.full((), seq, np.int32)
        out["tokens"] = rng.integers(0, cfg.vocab, (batch, tgt),
                                     dtype=np.int32)
        out["labels"] = rng.integers(0, cfg.vocab, (batch, tgt),
                                     dtype=np.int32)
        out["mask"] = np.ones((batch, tgt), np.float32)
        return out
    out["tokens"] = rng.integers(0, cfg.vocab, (batch, st), dtype=np.int32)
    lab_len = seq if cfg.patch_input else st
    out["labels"] = rng.integers(0, cfg.vocab, (batch, lab_len),
                                 dtype=np.int32)
    mask = np.ones((batch, lab_len), np.float32)
    if cfg.patch_input:
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.patch_dim), np.float32)
        mask[:, :cfg.n_patches] = 0.0      # no loss on image positions
    out["mask"] = mask
    return out


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               step: int = 0, *, device="cuda") -> dict:
    """Synthetic training batch (deterministic in (seed, step))."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in _arrays(cfg, batch, seq, seed, step).items()}


def input_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``meta`` tensors mirroring make_batch (dry run)."""
    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    st = _token_seq_len(cfg, seq)
    if cfg.family == "encdec":
        tgt = max(seq // 8, 32)
        return {
            "frames": sd((batch, seq, cfg.frame_dim), torch.float32),
            "frame_len": sd((), torch.int32),
            "tokens": sd((batch, tgt), torch.int32),
            "labels": sd((batch, tgt), torch.int32),
            "mask": sd((batch, tgt), torch.float32),
        }
    out = {
        "tokens": sd((batch, st), torch.int32),
        "labels": sd((batch, seq if cfg.patch_input else st), torch.int32),
        "mask": sd((batch, seq if cfg.patch_input else st), torch.float32),
    }
    if cfg.patch_input:
        out["patches"] = sd((batch, cfg.n_patches, cfg.patch_dim),
                            torch.float32)
    return out


class TokenPipeline:
    """Stateful iterator with skip-ahead (resume support)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, start_step: int = 0, *, device="cuda"):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.device = resolve_device(device)
        self.step = start_step

    def __next__(self):
        b = make_batch(self.cfg, self.batch, self.seq, self.seed,
                       self.step, device=self.device)
        self.step += 1
        return b

    def skip_to(self, step: int):
        self.step = step
