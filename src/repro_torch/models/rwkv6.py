"""RWKV6 "Finch": attention-free LM with data-dependent decay.

The port of ``repro.models.rwkv6``. Time-mix: per-channel
data-dependent decay w_t = exp(-exp(d_t)) where d_t comes from a
low-rank MLP of the token-shift-interpolated input, plus the per-head
bonus "u" for the current token. The wkv recurrence runs CHUNKED
(linear_attn.py).

Decode state per layer: wkv state (B,H,D,D) f32 + last-token shift
buffers — O(1) in sequence length.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, embed, init_params,
                                       rms_norm, softmax_xent, unstack)
from repro_torch.models.linear_attn import chunked_linear_attn
from repro_torch.models.transformer import checkpointed


def _token_shift(x, last):
    """x: (B,T,d); last: (B,1,d) from the previous segment."""
    return torch.cat([last, x[:, :-1]], dim=1)


def _time_mix(p, x, last, cfg: ModelConfig, state):
    b, t, d = x.shape
    h = cfg.ssm_heads
    hd = d // h
    prev = _token_shift(x, last)
    mix = p["mix_x"].to(x.dtype)                  # (5, d)
    xr = x + (prev - x) * mix[0]
    xk = x + (prev - x) * mix[1]
    xv = x + (prev - x) * mix[2]
    xg = x + (prev - x) * mix[3]
    xw = x + (prev - x) * mix[4]

    r = (xr @ p["wr"].to(x.dtype)).reshape(b, t, h, hd)
    k = (xk @ p["wk"].to(x.dtype)).reshape(b, t, h, hd)
    v = (xv @ p["wv"].to(x.dtype)).reshape(b, t, h, hd)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    # data-dependent decay (low-rank): logw in (-inf, 0)
    dd = torch.tanh(xw @ p["wd1"].to(x.dtype)) @ p["wd2"].to(x.dtype)
    logw = -torch.exp(torch.clamp(
        p["decay_base"].float().reshape(1, 1, h, hd) +
        dd.float().reshape(b, t, h, hd), -8.0, 4.0))
    bonus = p["bonus"].float()

    out, new_state = chunked_linear_attn(r, k, v, logw, state=state,
                                         bonus=bonus)
    out = out.reshape(b, t, d)
    out = rms_norm(out, p["ln_x"], cfg.norm_eps) * g
    return out @ p["wo"].to(x.dtype), new_state, x[:, -1:]


def _channel_mix(p, x, last, cfg: ModelConfig):
    prev = _token_shift(x, last)
    mix = p["mix_c"].to(x.dtype)
    xk = x + (prev - x) * mix[0]
    xr = x + (prev - x) * mix[1]
    k = torch.square(torch.relu(xk @ p["ck"].to(x.dtype)))
    return torch.sigmoid(xr) * (k @ p["cv"].to(x.dtype)), x[:, -1:]


class RWKV6Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed=0, *, device="cuda"):
        return init_params(self.cfg, seed, device=device)

    def init_state(self, batch_size: int, *, device="cuda"):
        cfg = self.cfg
        d = cfg.d_model
        h = cfg.ssm_heads
        hd = d // h
        ln = cfg.n_layers
        z = dict(device=device)
        return {
            "wkv": torch.zeros((ln, batch_size, h, hd, hd),
                               dtype=torch.float32, **z),
            "shift_t": torch.zeros((ln, batch_size, 1, d), dtype=cfg.cdtype,
                                   **z),
            "shift_c": torch.zeros((ln, batch_size, 1, d), dtype=cfg.cdtype,
                                   **z),
        }

    def _layer(self, lp, x, wkv, sh_t, sh_c):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, wkv2, sh_t2 = _time_mix(lp, h, sh_t, cfg, wkv)
        x = x + out
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        out, sh_c2 = _channel_mix(lp, h, sh_c, cfg)
        return x + out, wkv2, sh_t2, sh_c2

    def _forward(self, params, tokens, state, *, remat: bool = False,
                 last_only: bool = False):
        """With ``remat`` each layer is checkpointed and recomputed
        whole: the reference wraps this scan body in a plain
        ``jax.checkpoint``, which no remat policy reaches."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg.cdtype)
        news = ([], [], [])
        for i, lp in enumerate(unstack(params["layers"])):
            args = (lp, x, state["wkv"][i], state["shift_t"][i],
                    state["shift_c"][i])
            x, wkv2, sh_t2, sh_c2 = (
                checkpointed(self._layer, *args, policy=False) if remat
                else self._layer(*args))
            for acc, new in zip(news, (wkv2, sh_t2, sh_c2)):
                acc.append(new)
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["lm_head"].to(cfg.cdtype)
        new_state = {name: torch.stack(acc) for name, acc in
                     zip(("wkv", "shift_t", "shift_c"), news)}
        return logits, new_state

    def train_loss(self, params, batch):
        state = self.init_state(batch["tokens"].shape[0],
                                device=batch["tokens"].device)
        logits, _ = self._forward(params, batch["tokens"], state,
                                  remat=True)
        return softmax_xent(logits, batch["labels"], batch["mask"])

    def prefill(self, params, batch, max_len: Optional[int] = None):
        state = self.init_state(batch["tokens"].shape[0],
                                device=batch["tokens"].device)
        return self._forward(params, batch["tokens"], state, last_only=True)

    def decode_step(self, params, cache, tokens, pos=None):
        """State-based decode: cost independent of context length."""
        del pos
        return self._forward(params, tokens, cache)
