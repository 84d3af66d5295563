"""Decoder-only transformer (GQA/MLA, MoE, sliding-window) + enc-dec.

The port of ``repro.models.transformer``. Layers are stacked along a
leading axis, as in the reference, and run as a Python loop over views
``params["layers"][name][i]`` where the reference runs ``lax.scan``;
each layer's sliding window comes from ``cfg.window_for_layer`` (global
layers get GLOBAL_WINDOW), so gemma3's 5:1 local:global pattern lives
in one stack. In training (``train_loss``) every layer of the stack
runs under ``torch.utils.checkpoint`` where the reference wraps its
scan body in ``jax.checkpoint``; ``set_remat_policy`` picks what the
recomputation may keep.

DeepSeek-style "first layer dense FFN" layers (``layer{i}``) run before
the stack (their shapes differ from the MoE stack).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as A
from repro_torch.models.common import (ModelConfig, embed, init_params,
                                       layer, rms_norm, softmax_xent,
                                       swiglu, unstack)
from repro_torch.models.moe import moe_ffn

GLOBAL_WINDOW = A.GLOBAL_WINDOW

# the products without batch dimensions: 2-D matmuls (a 3-D activation
# times a 2-D weight runs as one ``mm``). Batched products (``bmm``:
# attention's einsums, the experts) have batch dimensions.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``:
    keep the outputs of the products without batch dimensions, recompute
    everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# remat policy toggle (the reference's ``_REMAT``): which intermediates
# a checkpointed layer may keep instead of recomputing
_REMAT = {"policy": None}


def set_remat_policy(name: str):
    """``"none"`` recomputes everything in the backward pass; ``"dots"``
    keeps the outputs of the products without batch dimensions."""
    table = {"none": None, "dots": _save_dots}
    _REMAT["policy"] = table[name]


def checkpointed(fn, *args, policy=True):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the backward pass runs ``fn`` again instead of keeping its
    intermediates, except those the remat policy keeps (``policy``
    False: none, as the reference's plain ``jax.checkpoint``)."""
    pol = _REMAT["policy"] if policy else None
    if pol is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, pol))


def pad_seq(a, max_len: int):
    """A stacked cache (L, B, S, ...) zero-padded along S to max_len."""
    s = a.shape[2]
    if s >= max_len:
        return a
    pad = [0, 0] * (a.ndim - 3) + [0, max_len - s]
    return F.pad(a, pad)


class TransformerModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params -----------------------------------------------------------

    def init(self, seed=0, *, device="cuda"):
        return init_params(self.cfg, seed, device=device)

    # -- embedding / head ---------------------------------------------------

    def _embed(self, params, batch):
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], cfg.cdtype)
        if cfg.patch_input and "patches" in batch:
            pe = batch["patches"].to(cfg.cdtype) @ \
                params["patch_proj"].to(cfg.cdtype)
            x = torch.cat([pe, x], dim=1)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"]).to(cfg.cdtype)
        return x @ head

    # -- one layer (shared by modes) ----------------------------------------

    def _attn_full(self, p, x, positions, window, qc, kc):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.attn == "mla":
            out, kv = A.mla_attn(p["attn"], h, cfg, positions=positions,
                                 q_chunk=qc, kv_chunk=kc)
        else:
            out, kv = A.gqa_attn(p["attn"], h, cfg, positions=positions,
                                 window=window, q_chunk=qc, kv_chunk=kc)
        return x + out, kv

    def _ffn(self, p, x):
        cfg = self.cfg
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            out, aux = moe_ffn(p["moe"], h, cfg)
        else:
            f = p["ffn"]
            out = swiglu(h, f["w1"].to(h.dtype), f["w3"].to(h.dtype),
                         f["w2"].to(h.dtype))
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + out, aux

    def _layer_full(self, p, x, positions, window, qc, kc):
        x, kv = self._attn_full(p, x, positions, window, qc, kc)
        x, aux = self._ffn(p, x)
        return x, kv, aux

    def _layers(self, params):
        """(params of layer i, its window, whether it is in the stack)
        for every layer, in order."""
        cfg = self.cfg
        fd = cfg.first_dense
        stack = unstack(params["layers"])
        for i in range(cfg.n_layers):
            p = params[f"layer{i}"] if i < fd else stack[i - fd]
            yield p, cfg.window_for_layer(i) or GLOBAL_WINDOW, i >= fd

    # -- full-sequence forward (train / prefill) -----------------------------

    def forward(self, params, batch, *, remat: bool = False,
                collect_cache: bool = False):
        """(logits, aux) over the whole sequence; with ``collect_cache``,
        (last-token logits, aux, the first_dense layers' [(k, v)], the
        stack's (K, V)) where K and V stack the stack's layers. With
        ``remat`` each layer of the stack is checkpointed (the
        first_dense layers are not, as in the reference)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        qc = min(512, s)
        kc = min(1024, s)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = []
        for p, w, stacked in self._layers(params):
            if remat and stacked:
                x, kv, aux = checkpointed(self._layer_full, p, x, positions,
                                          w, qc, kc)
            else:
                x, kv, aux = self._layer_full(p, x, positions, w, qc, kc)
            aux_total = aux_total + aux
            if collect_cache:
                kvs.append(kv)
        if not collect_cache:
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            return self._logits(params, x), aux_total
        x = x[:, -1:]              # prefill only needs last-token logits
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        fd = cfg.first_dense
        stack = tuple(torch.stack([kv[j] for kv in kvs[fd:]])
                      for j in range(2))
        return self._logits(params, x), aux_total, kvs[:fd], stack

    # -- training -----------------------------------------------------------

    def train_loss(self, params, batch):
        logits, aux = self.forward(params, batch, remat=True)
        loss = softmax_xent(logits, batch["labels"], batch["mask"])
        return loss + 0.01 * aux

    # -- serving ------------------------------------------------------------

    def _names(self):
        return ("c", "rope") if self.cfg.attn == "mla" else ("k", "v")

    def _stack_cache(self, fd_kv, kvs, max_len):
        out = {}
        for j, name in enumerate(self._names()):
            a = kvs[j]
            if fd_kv:
                a = torch.cat([torch.stack([kv[j] for kv in fd_kv]), a])
            out[name] = pad_seq(a, max_len)
        return out

    def init_cache(self, batch_size: int, max_len: int, *, device="cuda"):
        """Empty decode cache."""
        cfg = self.cfg
        ln = cfg.n_layers
        z = dict(dtype=cfg.cdtype, device=device)
        if cfg.attn == "mla":
            return {
                "c": torch.zeros((ln, batch_size, max_len, cfg.kv_lora), **z),
                "rope": torch.zeros((ln, batch_size, max_len,
                                     cfg.qk_rope_dim), **z),
            }
        return {
            "k": torch.zeros((ln, batch_size, max_len, cfg.n_kv_heads,
                              cfg.head_dim), **z),
            "v": torch.zeros((ln, batch_size, max_len, cfg.n_kv_heads,
                              cfg.head_dim), **z),
        }

    def prefill(self, params, batch, max_len: Optional[int] = None):
        s = batch["tokens"].shape[1] + (
            self.cfg.n_patches if (self.cfg.patch_input and
                                   "patches" in batch) else 0)
        max_len = max_len or s
        logits, _, fd_kv, kvs = self.forward(params, batch,
                                             collect_cache=True)
        return logits, self._stack_cache(fd_kv, kvs, max_len)

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B,1), pos (an int or a 0-dim tensor) -> (logits
        (B,1,V), cache); ``cache`` itself is left as it was."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg.cdtype)
        pos = A.as_pos(pos, x.device)       # one copy to the device
        n0, n1 = self._names()
        c0, c1 = cache[n0].clone(), cache[n1].clone()
        for i, (p, w, _) in enumerate(self._layers(params)):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            if cfg.attn == "mla":
                out, _ = A.mla_decode(p["attn"], h, cfg, cache_c=c0[i],
                                      cache_rope=c1[i], pos=pos)
            else:
                out, _ = A.gqa_decode(p["attn"], h, cfg, cache_k=c0[i],
                                      cache_v=c1[i], pos=pos, window=w)
            x, _ = self._ffn(p, x + out)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), {n0: c0, n1: c1}


# ---------------------------------------------------------------------------
# encoder-decoder (seamless-m4t backbone; audio frontend is a stub)
# ---------------------------------------------------------------------------

class EncDecModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed=0, *, device="cuda"):
        return init_params(self.cfg, seed, device=device)

    def encode(self, params, frames):
        """frames: (B, Ss, frame_dim) precomputed embeddings (stub)."""
        cfg = self.cfg
        x = frames.to(cfg.cdtype) @ params["frame_proj"].to(cfg.cdtype)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        qc, kc = min(512, s), min(1024, s)
        for lp in unstack(params["enc_layers"]):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            out, _ = A.gqa_attn(lp["attn"], h, cfg, positions=positions,
                                q_chunk=qc, kv_chunk=kc, causal=False)
            x = x + out
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            f = lp["ffn"]
            x = x + swiglu(h, f["w1"].to(h.dtype), f["w3"].to(h.dtype),
                           f["w2"].to(h.dtype))
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _memory_kv(self, lp, mem):
        """Cross-attention K and V of the encoder memory (no rope)."""
        cfg = self.cfg
        b, s = mem.shape[:2]
        mk = (mem @ lp["xattn"]["wk"].to(mem.dtype)).reshape(
            b, s, cfg.n_kv_heads, cfg.head_dim)
        mv = (mem @ lp["xattn"]["wv"].to(mem.dtype)).reshape(
            b, s, cfg.n_kv_heads, cfg.head_dim)
        return mk, mv

    def _dec_layer(self, lp, x, mem, positions, mem_len, qc, kc):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, kv = A.gqa_attn(lp["attn"], h, cfg, positions=positions,
                             q_chunk=qc, kv_chunk=kc)
        x = x + out
        # cross attention (no rope on memory)
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        q, _, _ = A.gqa_project(lp["xattn"], h, cfg)
        mk, mv = self._memory_kv(lp, mem)
        mpos = torch.arange(mem.shape[1], dtype=torch.int32,
                            device=x.device)
        out = A.flash_attention(
            q, mk, mv, q_pos=torch.full((q.shape[1],), mem.shape[1],
                                        dtype=torch.int32, device=x.device),
            k_pos=mpos, kv_len=mem_len, q_chunk=min(512, q.shape[1]),
            kv_chunk=min(1024, mem.shape[1]))
        x = x + out.reshape(x.shape) @ lp["xattn"]["wo"].to(x.dtype)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        f = lp["ffn"]
        x = x + swiglu(h, f["w1"].to(h.dtype), f["w3"].to(h.dtype),
                       f["w2"].to(h.dtype))
        return x, kv

    def forward(self, params, batch, collect_cache: bool = False):
        """(logits, memory, (K, V) of the decoder's self attention
        stacked over its layers, or None without ``collect_cache``)."""
        cfg = self.cfg
        mem = self.encode(params, batch["frames"])
        mem_len = batch.get("frame_len")
        tok = batch["tokens"]
        x = embed(params["embed"], tok, cfg.cdtype)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        qc, kc = min(512, s), min(1024, s)
        kvs = []
        for lp in unstack(params["dec_layers"]):
            x, kv = self._dec_layer(lp, x, mem, positions, mem_len, qc, kc)
            if collect_cache:
                kvs.append(kv)
        if collect_cache:
            x = x[:, -1:]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["lm_head"].to(cfg.cdtype)
        if not collect_cache:
            return logits, mem, None
        return logits, mem, tuple(torch.stack([kv[j] for kv in kvs])
                                  for j in range(2))

    def train_loss(self, params, batch):
        logits, _, _ = self.forward(params, batch)
        return softmax_xent(logits, batch["labels"], batch["mask"])

    def prefill(self, params, batch, max_len: Optional[int] = None):
        cfg = self.cfg
        logits, mem, kvs = self.forward(params, batch, collect_cache=True)
        max_len = max_len or batch["tokens"].shape[1]
        # the cross-attention K/V, computed once per layer over memory
        xkv = [self._memory_kv(layer(params["dec_layers"], i), mem)
               for i in range(cfg.dec_layers)]
        cache = {"k": pad_seq(kvs[0], max_len),
                 "v": pad_seq(kvs[1], max_len),
                 "xk": torch.stack([a for a, _ in xkv]),
                 "xv": torch.stack([b for _, b in xkv])}
        return logits, cache

    def init_cache(self, batch_size: int, max_len: int, src_len: int, *,
                   device="cuda"):
        cfg = self.cfg
        ln = cfg.dec_layers
        kvh = cfg.n_kv_heads
        z = dict(dtype=cfg.cdtype, device=device)
        return {
            "k": torch.zeros((ln, batch_size, max_len, kvh, cfg.head_dim),
                             **z),
            "v": torch.zeros((ln, batch_size, max_len, kvh, cfg.head_dim),
                             **z),
            "xk": torch.zeros((ln, batch_size, src_len, kvh, cfg.head_dim),
                              **z),
            "xv": torch.zeros((ln, batch_size, src_len, kvh, cfg.head_dim),
                              **z),
        }

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B,1), pos (an int or a 0-dim tensor) -> (logits
        (B,1,V), cache); ``cache`` itself is left as it was."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg.cdtype)
        pos = A.as_pos(pos, x.device)
        b = x.shape[0]
        g = cfg.n_heads // cfg.n_kv_heads
        ck, cv = cache["k"].clone(), cache["v"].clone()
        for i in range(cfg.dec_layers):
            lp = layer(params["dec_layers"], i)
            xk, xv = cache["xk"][i], cache["xv"][i]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            out, _ = A.gqa_decode(lp["attn"], h, cfg, cache_k=ck[i],
                                  cache_v=cv[i], pos=pos,
                                  window=GLOBAL_WINDOW)
            x = x + out
            # cross attention against the precomputed memory K/V
            h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
            q, _, _ = A.gqa_project(lp["xattn"], h, cfg)
            qg = q.reshape(b, cfg.n_kv_heads, g, cfg.head_dim) * A.weak(
                cfg.head_dim ** -0.5, q.dtype)
            # preferred_element_type=float32 in the reference
            s = torch.einsum("bkgd,bskd->bkgs", qg.float(), xk.float())
            pattn = torch.softmax(s, dim=-1).to(xv.dtype)
            ctx = torch.einsum("bkgs,bskv->bkgv", pattn.float(), xv.float())
            x = x + ctx.reshape(b, 1, -1).to(x.dtype) @ \
                lp["xattn"]["wo"].to(x.dtype)
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            f = lp["ffn"]
            x = x + swiglu(h, f["w1"].to(h.dtype), f["w3"].to(h.dtype),
                           f["w2"].to(h.dtype))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["lm_head"].to(cfg.cdtype)
        return logits, dict(cache, k=ck, v=cv)
