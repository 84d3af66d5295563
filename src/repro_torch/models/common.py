"""Shared model components: config, norms, rope, ffn, losses, init.

The port of ``repro.models.common``. Parameters are a nested dict of
float32 tensors with the reference's paths and shapes (a stacked
leading layer axis on every scanned stack, ``init_shapes``); each use
casts a weight to the compute dtype, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch._num import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes every supported architecture family."""

    name: str = "model"
    family: str = "transformer"  # transformer | rwkv6 | hymba | encdec
    vocab: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 4096
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention flavour
    attn: str = "gqa"            # gqa | mla
    # MLA (DeepSeek-V2 / MiniCPM3)
    q_lora: int = 0              # 0 => full-rank Q projection
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # sliding-window pattern: every `global_every`-th layer is global
    # (gemma3 5:1), or the explicit `global_layers` indices (hymba
    # first/middle/last); other layers use `window`; window == 0 -> all
    # layers global.
    window: int = 0
    global_every: int = 0
    global_layers: Tuple[int, ...] = ()

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 2
    d_expert: int = 0
    first_dense: int = 0         # first K layers use a dense FFN
    d_ff_dense: int = 0
    capacity_factor: float = 1.25

    # SSM / RWKV / hymba
    ssm_state: int = 16
    ssm_heads: int = 0
    ssm_head_dim: int = 64

    # enc-dec (seamless)
    enc_layers: int = 0
    dec_layers: int = 0

    # modality stubs
    patch_input: bool = False    # VLM: precomputed patch embeddings
    n_patches: int = 256
    patch_dim: int = 1024
    frame_input: bool = False    # audio: precomputed frame embeddings
    frame_dim: int = 1024

    max_seq: int = 131072
    compute_dtype: str = "bfloat16"

    @property
    def cdtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown compute dtype {self.compute_dtype!r}")
        return dt

    def window_for_layer(self, i: int) -> int:
        """0 = global attention; otherwise sliding-window size."""
        if self.window == 0:
            return 0
        if i in self.global_layers:
            return 0
        if self.global_every and (i % self.global_every ==
                                  self.global_every - 1):
            return 0
        return self.window

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        return int(sum(math.prod(s) for _, s in
                       tree_items(init_shapes(self))))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        ex = 3 * self.d_model * self.d_expert
        n_moe_layers = self.n_layers - self.first_dense
        inactive = n_moe_layers * ex * (self.n_experts - self.top_k)
        return int(total - inactive)


# ---------------------------------------------------------------------------
# parameter trees (nested dicts; leaves are shape tuples or tensors)
# ---------------------------------------------------------------------------

def tree_items(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in the order ``jax.tree_util`` flattens a
    nested dict: keys sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_map(fn, tree):
    """The same nested dict with ``fn`` applied to every leaf."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def layer(tree, i: int):
    """Layer ``i`` of a stacked subtree: views, no copies (the port's
    counterpart of one step of the reference's ``lax.scan``)."""
    return tree_map(lambda a: a[i], tree)


def unstack(tree) -> list:
    """Every layer of a stacked subtree, in order, as views (``unbind``).
    The forward passes that train take their layers from here: the
    gradient of one ``unbind`` is one stack into the stacked leaf, where
    a ``layer`` view per layer would each write a zero tensor of the
    whole stack (L of them, each L layers big)."""
    per = tree_map(lambda a: a.unbind(0), tree)
    n = len(next(leaf for _, leaf in tree_items(per)))
    return [tree_map(lambda views: views[i], per) for i in range(n)]


# ---------------------------------------------------------------------------
# primitive layers (pure functions over param dicts)
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    # in float32, then ``* (1 + scale)``, then back: the reference's order.
    # A bfloat16 scale (``bf16_weights`` training) is summed in float32:
    # XLA:CPU keeps the excess precision of ``1 + scale`` there
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_tables(positions, dim: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., dim/2)."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, T, H, D); cos/sin: (B, T, D/2) or (T, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    # bf16 x times float32 cos promotes to float32 in both libraries;
    # the cast back comes after the concatenation, as in the reference
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def embed(table, tokens, dtype):
    """Rows ``tokens`` of ``table`` cast to ``dtype``. The reference casts
    the whole table, then gathers. The port gathers, then casts (the
    same values, without the cast of the whole table), except where the
    table takes a gradient: there it casts first, as the reference does,
    so the rows' gradients accumulate in ``dtype`` as the reference's."""
    if table.requires_grad and torch.is_grad_enabled():
        return table.to(dtype)[tokens]
    return table[tokens].to(dtype)


def swiglu(x, w1, w3, w2):
    """Gated MLP: silu(x@w1) * (x@w3) @ w2."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def softmax_xent(logits, labels, mask):
    """Mean CE over masked tokens. logits (B,S,V) f32; labels (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_shapes(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    return {"w1": (d, d_ff), "w3": (d, d_ff), "w2": (d_ff, d)}


def _attn_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.attn == "mla":
        qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
        sh = {
            "w_dkv": (d, cfg.kv_lora + cfg.qk_rope_dim),
            "kv_norm": (cfg.kv_lora,),
            "w_uk": (cfg.kv_lora, cfg.n_heads * cfg.qk_nope_dim),
            "w_uv": (cfg.kv_lora, cfg.n_heads * cfg.v_head_dim),
            "wo": (cfg.n_heads * cfg.v_head_dim, d),
        }
        if cfg.q_lora:
            sh["w_dq"] = (d, cfg.q_lora)
            sh["q_norm"] = (cfg.q_lora,)
            sh["w_uq"] = (cfg.q_lora, cfg.n_heads * qk_dim)
        else:
            sh["wq"] = (d, cfg.n_heads * qk_dim)
        return sh
    sh = {
        "wq": (d, cfg.n_heads * cfg.head_dim),
        "wk": (d, cfg.n_kv_heads * cfg.head_dim),
        "wv": (d, cfg.n_kv_heads * cfg.head_dim),
        "wo": (cfg.n_heads * cfg.head_dim, d),
    }
    if cfg.qkv_bias:
        sh["bq"] = (cfg.n_heads * cfg.head_dim,)
        sh["bk"] = (cfg.n_kv_heads * cfg.head_dim,)
        sh["bv"] = (cfg.n_kv_heads * cfg.head_dim,)
    return sh


def _moe_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    sh = {
        "router": (d, cfg.n_experts),
        "we1": (cfg.n_experts, d, cfg.d_expert),
        "we3": (cfg.n_experts, d, cfg.d_expert),
        "we2": (cfg.n_experts, cfg.d_expert, d),
    }
    if cfg.n_shared:
        f = cfg.d_expert * cfg.n_shared
        sh.update({"ws1": (d, f), "ws3": (d, f), "ws2": (f, d)})
    return sh


def _rwkv_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.ssm_heads
    hd = d // h
    return {
        "ln1": (d,), "ln2": (d,),
        # time-mix: r, k, v, gate, decay projections + per-head bonus
        "mix_x": (5, d),                  # token-shift interpolation
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
        "wd1": (d, 64), "wd2": (64, d),   # data-dependent decay (lora)
        "decay_base": (h, hd),
        "bonus": (h, hd),
        "ln_x": (d,),
        "wo": (d, d),
        # channel-mix
        "mix_c": (2, d),
        "ck": (d, cfg.d_ff), "cv": (cfg.d_ff, d),
    }


def _hymba_layer_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    hm = cfg.ssm_heads
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    return {
        "ln1": (d,), "ln2": (d,),
        "attn": _attn_shapes(cfg),
        # parallel mamba(SSD) heads on the same residual input
        "ssm": {
            "wx": (d, hm * p), "wb": (d, n), "wc": (d, n),
            "wdt": (d, hm), "a_log": (hm,), "dskip": (hm, p),
            "wo": (hm * p, d), "norm": (hm * p,),
        },
        "ffn": _dense_shapes(cfg, cfg.d_ff),
    }


def transformer_layer_shapes(cfg: ModelConfig, layer_idx: int) -> dict:
    d = cfg.d_model
    sh = {"ln1": (d,), "ln2": (d,), "attn": _attn_shapes(cfg)}
    if cfg.moe and layer_idx >= cfg.first_dense:
        sh["moe"] = _moe_shapes(cfg)
    else:
        d_ff = cfg.d_ff_dense if (cfg.moe and cfg.d_ff_dense) else cfg.d_ff
        sh["ffn"] = _dense_shapes(cfg, d_ff)
    return sh


def _stack(n: int, tree):
    """Prefix every shape tuple in the tree with a layer axis."""
    return tree_map(lambda s: (n,) + s, tree)


def init_shapes(cfg: ModelConfig) -> dict:
    """Full parameter shape tree (mirrors init())."""
    d = cfg.d_model
    sh = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        sh["lm_head"] = (d, cfg.vocab)
    if cfg.patch_input:
        sh["patch_proj"] = (cfg.patch_dim, d)
    if cfg.frame_input:
        sh["frame_proj"] = (cfg.frame_dim, d)
    if cfg.family == "rwkv6":
        sh["layers"] = _stack(cfg.n_layers, _rwkv_shapes(cfg))
    elif cfg.family == "hymba":
        sh["layers"] = _stack(cfg.n_layers, _hymba_layer_shapes(cfg))
    elif cfg.family == "encdec":
        sh["enc_layers"] = _stack(cfg.enc_layers,
                                  transformer_layer_shapes(cfg, 0))
        dec = transformer_layer_shapes(cfg, 0)
        dec["xattn"] = _attn_shapes(cfg)
        dec["ln_x"] = (d,)
        sh["dec_layers"] = _stack(cfg.dec_layers, dec)
        sh["enc_norm"] = (d,)
    else:
        # uniform stack for layers >= first_dense; the first
        # `first_dense` layers (deepseek dense-FFN layer 0) are separate.
        for i in range(cfg.first_dense):
            sh[f"layer{i}"] = transformer_layer_shapes(cfg, i)
        n_scan = cfg.n_layers - cfg.first_dense
        body = transformer_layer_shapes(cfg, cfg.first_dense)
        sh["layers"] = _stack(n_scan, body)
    return sh


def init_params(cfg: ModelConfig,
                seed: Union[int, torch.Generator] = 0, *,
                device="cuda") -> dict:
    """Gaussian init (std 0.02) on ``device``; norms and every 1-D leaf
    start at zero (rms_norm adds 1). ``seed`` is an int or a
    ``torch.Generator`` on that device; leaves are drawn in the
    reference's flattening order. The values differ from the
    reference's ``jax.random`` draws by design: carry its weights over
    with ``convert.params_from_arrays`` for parity. On ``meta`` the
    leaves are empty tensors of the same shapes."""
    if torch.device(device).type == "meta":
        # shapes and dtypes only, nothing drawn: the prototype that
        # checkpoint.restore_or_init loads into
        return tree_map(lambda s: torch.empty(s, dtype=torch.float32,
                                              device="meta"),
                        init_shapes(cfg))
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    out = {}
    for path, shape in tree_items(init_shapes(cfg)):
        if len(shape) == 1 or shape[-1] == 1:
            leaf = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            leaf = torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=dev).mul_(0.02)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
