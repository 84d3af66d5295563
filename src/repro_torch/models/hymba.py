"""Hymba: hybrid-head layers — attention heads and Mamba2-style SSD heads
run IN PARALLEL on the same residual input; their outputs fuse by
averaging. Most layers use sliding-window attention; first/middle/last
are global (cfg.global_layers).

The port of ``repro.models.hymba``. SSD branch: scalar per-head decay
a*dt (Mamba2), state (N x P) per head, computed chunkwise via the
shared linear_attn scan. The decay-shift trick (q premultiplied by
exp(a*dt)) converts the "decay applies to current state" SSM convention
into the linear-attn form; the current-token (diagonal) term is added
in closed form.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models.common import (ModelConfig, embed, init_params,
                                       layer, rms_norm, softmax_xent,
                                       swiglu, unstack)
from repro_torch.models.linear_attn import chunked_linear_attn
from repro_torch.models.transformer import (GLOBAL_WINDOW, checkpointed,
                                            pad_seq)


def _ssd_project(p, x, cfg: ModelConfig):
    b, t, _ = x.shape
    hm, pp = cfg.ssm_heads, cfg.ssm_head_dim
    xs = (x @ p["wx"].to(x.dtype)).reshape(b, t, hm, pp)
    bt = x @ p["wb"].to(x.dtype)                     # (B,T,N)
    ct = x @ p["wc"].to(x.dtype)
    dt = F.softplus((x @ p["wdt"].to(x.dtype)).float())  # (B,T,Hm)
    a = -torch.exp(p["a_log"].float())               # (Hm,)
    logw = a * dt                                    # (B,T,Hm) <= 0
    return xs, bt, ct, dt, logw


def ssd_branch(p, x, cfg: ModelConfig, state=None):
    """Mamba2-SSD over the full sequence. Returns (out, final state)."""
    b, t, _ = x.shape
    hm, pp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xs, bt, ct, dt, logw = _ssd_project(p, x, cfg)
    v = (xs.float() * dt[..., None]).to(x.dtype)
    k = bt[:, :, None, :].expand(b, t, hm, n).to(x.dtype)
    q_raw = ct[:, :, None, :].expand(b, t, hm, n)
    # decay-shift: current-state convention -> linear-attn convention
    q = (q_raw.float() * torch.exp(logw)[..., None]).to(x.dtype)
    lw = logw[..., None].expand(b, t, hm, n)
    out, new_state = chunked_linear_attn(q, k, v, lw, state=state)
    # diagonal (current token): C.B * (dt x)
    diag = torch.einsum("btn,btn->bt", ct.float(), bt.float())
    out = out + (diag[:, :, None, None] * v.float()).to(out.dtype)
    out = out + p["dskip"].to(out.dtype) * xs
    out = rms_norm(out.reshape(b, t, hm * pp), p["norm"], cfg.norm_eps)
    return out @ p["wo"].to(x.dtype), new_state


def ssd_decode(p, x, cfg: ModelConfig, state):
    """One-token SSD: h = e^{a dt} h + dt B x ; y = C h + D x."""
    b = x.shape[0]
    hm, pp = cfg.ssm_heads, cfg.ssm_head_dim
    xs, bt, ct, dt, logw = _ssd_project(p, x, cfg)
    w = torch.exp(logw[:, 0])                             # (B,Hm)
    kv = torch.einsum("bn,bhp->bhnp", bt[:, 0].float(),
                      xs[:, 0].float() * dt[:, 0][..., None])
    new_state = w[..., None, None] * state + kv
    y = torch.einsum("bn,bhnp->bhp", ct[:, 0].float(), new_state)
    y = y + p["dskip"].float() * xs[:, 0].float()
    y = rms_norm(y.reshape(b, 1, hm * pp).to(x.dtype), p["norm"],
                 cfg.norm_eps)
    return y @ p["wo"].to(x.dtype), new_state


class HymbaModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed=0, *, device="cuda"):
        return init_params(self.cfg, seed, device=device)

    def init_cache(self, batch_size: int, max_len: int, *, device="cuda"):
        cfg = self.cfg
        ln = cfg.n_layers
        z = dict(device=device)
        return {
            "k": torch.zeros((ln, batch_size, max_len, cfg.n_kv_heads,
                              cfg.head_dim), dtype=cfg.cdtype, **z),
            "v": torch.zeros((ln, batch_size, max_len, cfg.n_kv_heads,
                              cfg.head_dim), dtype=cfg.cdtype, **z),
            "ssm": torch.zeros((ln, batch_size, cfg.ssm_heads,
                                cfg.ssm_state, cfg.ssm_head_dim),
                               dtype=torch.float32, **z),
        }

    def _layer_full(self, lp, x, positions, w, qc, kc):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, kv = A.gqa_attn(lp["attn"], h, cfg, positions=positions,
                                  window=w, q_chunk=qc, kv_chunk=kc)
        # every layer's SSD starts from a zero state, as in the reference
        ssm_out, new_ssm = ssd_branch(lp["ssm"], h, cfg)
        x = x + 0.5 * (attn_out + ssm_out)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        f = lp["ffn"]
        x = x + swiglu(h, f["w1"].to(h.dtype), f["w3"].to(h.dtype),
                       f["w2"].to(h.dtype))
        return x, kv, new_ssm

    def forward(self, params, batch, *, remat=False, collect_cache=False):
        """(logits, None), or with ``collect_cache`` (last-token logits,
        ((K, V), SSM states)) stacked over the layers; with ``remat``
        each layer is checkpointed."""
        cfg = self.cfg
        tok = batch["tokens"]
        x = embed(params["embed"], tok, cfg.cdtype)
        s = tok.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=tok.device)
        qc, kc = min(512, s), min(1024, s)
        ks, vs, ssms = [], [], []
        for i, lp in enumerate(unstack(params["layers"])):
            args = (lp, x, positions,
                    cfg.window_for_layer(i) or GLOBAL_WINDOW, qc, kc)
            x, (k, v), st = (checkpointed(self._layer_full, *args) if remat
                             else self._layer_full(*args))
            if collect_cache:
                ks.append(k)
                vs.append(v)
                ssms.append(st)
        if collect_cache:
            x = x[:, -1:]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["lm_head"].to(cfg.cdtype)
        if not collect_cache:
            return logits, None
        return logits, ((torch.stack(ks), torch.stack(vs)),
                        torch.stack(ssms))

    def train_loss(self, params, batch):
        logits, _ = self.forward(params, batch, remat=True)
        return softmax_xent(logits, batch["labels"], batch["mask"])

    def prefill(self, params, batch, max_len: Optional[int] = None):
        s = batch["tokens"].shape[1]
        max_len = max_len or s
        logits, ((k, v), ssm) = self.forward(params, batch,
                                             collect_cache=True)
        return logits, {"k": pad_seq(k, max_len), "v": pad_seq(v, max_len),
                        "ssm": ssm}

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B,1), pos (an int or a 0-dim tensor) -> (logits
        (B,1,V), cache); ``cache`` itself is left as it was."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg.cdtype)
        pos = A.as_pos(pos, x.device)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        news = []
        for i in range(cfg.n_layers):
            lp = layer(params["layers"], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            attn_out, _ = A.gqa_decode(
                lp["attn"], h, cfg, cache_k=ck[i], cache_v=cv[i], pos=pos,
                window=cfg.window_for_layer(i) or GLOBAL_WINDOW)
            ssm_out, new_st = ssd_decode(lp["ssm"], h, cfg, cache["ssm"][i])
            x = x + 0.5 * (attn_out + ssm_out)
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            f = lp["ffn"]
            x = x + swiglu(h, f["w1"].to(h.dtype), f["w3"].to(h.dtype),
                           f["w2"].to(h.dtype))
            news.append(new_st)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["lm_head"].to(cfg.cdtype)
        return logits, {"k": ck, "v": cv, "ssm": torch.stack(news)}
