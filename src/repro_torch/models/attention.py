"""Attention variants: GQA (flash-style chunked, sliding-window) and MLA.

The port of ``repro.models.attention``; everything is a pure function
over param dicts, except that the decode steps write the new token into
the cache they are given (the model's ``decode_step`` hands them its
own copy).

* ``flash_attention`` — blockwise online-softmax attention (a loop over
  query and key chunks) so long prefills never materialize a (S x S)
  score matrix. Masks are position-based: causal, sliding-window, and
  kv-length (for padded decode caches).
* GQA grouping is done by reshaping q to (B, T, KV, G, D), so kv heads are
  never materialized repeated.
* MLA (DeepSeek-V2): the expanded form for prefill; decodes in the
  ABSORBED form with a compressed (kv_lora + rope) cache.

Where the reference asks for ``preferred_element_type=float32`` (JAX
multiplies bf16 operands exactly and accumulates and returns float32),
``torch.einsum`` on bf16 would round its result to bf16: the port casts
both operands to float32 there (``_f32``), and casts back where the
reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import (ModelConfig, apply_rope, rms_norm,
                                       rope_tables)

NEG_INF = -1.0e30

GLOBAL_WINDOW = 1 << 30  # "no window": larger than any supported seq


def _f32(*xs):
    """The operands of a product the reference computes with
    ``preferred_element_type=jnp.float32``, as float32."""
    return [x.float() for x in xs]


def weak(c: float, dtype: torch.dtype) -> float:
    """The Python scalar ``c`` as JAX applies it to an array of
    ``dtype``: a weakly typed scalar is rounded to the array's dtype
    first (torch would multiply a bf16 tensor by ``c`` in float32)."""
    return float(torch.tensor(c, dtype=dtype))


def as_pos(pos, device) -> torch.Tensor:
    """A decode position (a Python int or a 0-dim integer tensor) as a
    0-dim int32 tensor on ``device``."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device)


def write_slot(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """``cache[:, pos] = new`` in place, with ``pos`` clamped to the last
    slot: ``jax.lax.dynamic_update_slice`` clamps its start so the
    update fits, and ``ServeSession.step`` advances past ``max_len``
    without bound, so the reference overwrites the last slot there."""
    at = pos.clamp(0, cache.shape[1] - 1).reshape(1).long()
    cache.index_copy_(1, at, new.to(cache.dtype))
    return cache


def _mask(q_pos, k_pos, window, kv_len, causal: bool):
    """(Tq, Tk) validity mask from positions. GLOBAL_WINDOW disables the
    window arithmetically."""
    if causal:
        m = k_pos[None, :] <= q_pos[:, None]
    else:
        m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    m = m & ((q_pos[:, None] - k_pos[None, :]) < window)
    if kv_len is not None:
        m = m & (k_pos[None, :] < kv_len)
    return m


def flash_attention(q, k, v, *, q_pos, k_pos, window=GLOBAL_WINDOW,
                    kv_len=None, q_chunk: int = 512, kv_chunk: int = 1024,
                    scale: Optional[float] = None, causal: bool = True):
    """Blockwise attention. q: (B,Tq,H,D); k,v: (B,Tk,KV,Dk/Dv).

    Returns (B, Tq, H, Dv). H must be a multiple of KV (GQA groups).
    """
    b, tq, h, d = q.shape
    _, tk, kv, dv = v.shape
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qc = min(q_chunk, tq)
    kc = min(kv_chunk, tk)
    if tq % qc or tk % kc:
        raise ValueError(f"chunks ({qc}, {kc}) do not divide ({tq}, {tk})")
    nq, nk = tq // qc, tk // kc

    qg = q.reshape(b, nq, qc, kv, g, d) * weak(scale, q.dtype)
    kg = k.reshape(b, nk, kc, kv, d)
    vg = v.reshape(b, nk, kc, kv, dv)
    qp = q_pos.reshape(nq, qc)
    kp = k_pos.reshape(nk, kc)

    outs = []
    for i in range(nq):
        m_run = torch.full((b, kv, g, qc), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, kv, g, qc), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, kv, g, qc, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            vblk = vg[:, j]
            s = torch.einsum("bqkgd,bckd->bkgqc", *_f32(qg[:, i], kg[:, j]))
            mask = _mask(qp[i], kp[j], window, kv_len, causal)  # (qc, kc)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            # p rounds to v's dtype, then the product is float32 again
            pv = torch.einsum("bkgqc,bckv->bkgqv",
                              *_f32(p.to(vblk.dtype), vblk))
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                     # (B,KV,G,qc,Dv)
    # (B, nq, KV, G, qc, Dv) -> (B, nq, qc, KV, G, Dv): the reference's
    # transpose (0, 4, 1, 2, 3, 5) puts qc before nq, which interleaves
    # the rows of its query chunks whenever Tq > q_chunk (ROADMAP §3);
    # at Tq <= q_chunk the two orders are the same
    out = torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(b, tq, h, dv)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_project(p, x, cfg: ModelConfig):
    b, t, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def gqa_attn(p, x, cfg: ModelConfig, *, positions, window=GLOBAL_WINDOW,
             q_chunk=512, kv_chunk=1024, causal: bool = True):
    """Full-sequence (prefill) GQA. Returns (out, (k, v))."""
    b, t, _ = x.shape
    q, k, v = gqa_project(p, x, cfg)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, q_pos=positions, k_pos=positions,
                          window=window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, causal=causal)
    out = out.reshape(b, t, -1) @ p["wo"].to(x.dtype)
    return out, (k, v)


def gqa_decode(p, x, cfg: ModelConfig, *, cache_k, cache_v, pos,
               window=GLOBAL_WINDOW):
    """One-token decode against a padded cache. x: (B,1,d). Writes the
    token's k and v into ``cache_k``/``cache_v`` (B,S,KV,D) at ``pos``
    (clamped to the last slot) and returns (out, (cache_k, cache_v))."""
    b = x.shape[0]
    s_max = cache_k.shape[1]
    pos = as_pos(pos, x.device)
    q, k, v = gqa_project(p, x, cfg)
    cos, sin = rope_tables(pos[None], cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    write_slot(cache_k, k, pos)
    write_slot(cache_v, v, pos)
    kv_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, g, cfg.head_dim) * weak(
        cfg.head_dim ** -0.5, q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", *_f32(qg, cache_k))
    valid = (kv_pos <= pos) & ((pos - kv_pos) < window)
    s = torch.where(valid, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1).to(cache_v.dtype)
    ctx = torch.einsum("bkgs,bskv->bkgv", *_f32(pattn, cache_v))
    out = ctx.reshape(b, 1, -1).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------

def _mla_q(p, x, cfg: ModelConfig, positions):
    b, t, _ = x.shape
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora:
        cq = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
        q = cq @ p["w_uq"].to(x.dtype)
    else:
        q = x @ p["wq"].to(x.dtype)
    q = q.reshape(b, t, cfg.n_heads, qk)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = q[..., cfg.qk_nope_dim:]
    cos, sin = rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope, (cos, sin)


def mla_compress(p, x, cfg: ModelConfig, positions):
    """x -> (c_kv normed (B,T,r), k_rope (B,T,1,rope))."""
    ckv = x @ p["w_dkv"].to(x.dtype)
    c, k_rope = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)
    return c, k_rope


def mla_attn(p, x, cfg: ModelConfig, *, positions, q_chunk=512,
             kv_chunk=1024):
    """Expanded-form MLA (prefill). Returns (out, (c, k_rope))."""
    b, t, _ = x.shape
    q_nope, q_rope, _ = _mla_q(p, x, cfg, positions)
    c, k_rope = mla_compress(p, x, cfg, positions)
    k_nope = (c @ p["w_uk"].to(x.dtype)).reshape(b, t, cfg.n_heads,
                                                 cfg.qk_nope_dim)
    v = (c @ p["w_uv"].to(x.dtype)).reshape(b, t, cfg.n_heads,
                                            cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, t, cfg.n_heads,
                                         cfg.qk_rope_dim)], dim=-1)
    out = flash_attention(q, k, v, q_pos=positions, k_pos=positions,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out.reshape(b, t, -1) @ p["wo"].to(x.dtype)
    return out, (c, k_rope[:, :, 0, :])


def mla_decode(p, x, cfg: ModelConfig, *, cache_c, cache_rope, pos):
    """Absorbed-form one-token decode. cache_c: (B,S,r); cache_rope:
    (B,S,rope), written at ``pos`` (clamped) in place. The per-token
    cache is r + rope floats (vs 2*H*D for GQA)."""
    b = x.shape[0]
    s_max = cache_c.shape[1]
    pos = as_pos(pos, x.device)
    q_nope, q_rope, _ = _mla_q(p, x, cfg, pos[None])
    c_new, k_rope_new = mla_compress(p, x, cfg, pos[None])
    write_slot(cache_c, c_new, pos)
    write_slot(cache_rope, k_rope_new[:, :, 0, :], pos)
    # absorb w_uk into q: (B,1,H,nope) x (r,H,nope) -> (B,H,r)
    w_uk = p["w_uk"].to(x.dtype).reshape(cfg.kv_lora, cfg.n_heads,
                                         cfg.qk_nope_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    s = (torch.einsum("bhr,bsr->bhs", *_f32(q_abs, cache_c)) +
         torch.einsum("bhp,bsp->bhs", *_f32(q_rope[:, 0], cache_rope)))
    s = s * (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    kv_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
    s = torch.where(kv_pos <= pos, s, NEG_INF)
    pattn = torch.softmax(s, dim=-1).to(cache_c.dtype)
    ctx = torch.einsum("bhs,bsr->bhr", *_f32(pattn, cache_c)).to(x.dtype)
    w_uv = p["w_uv"].to(x.dtype).reshape(cfg.kv_lora, cfg.n_heads,
                                         cfg.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    out = o.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
    return out, (cache_c, cache_rope)
