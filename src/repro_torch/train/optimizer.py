"""AdamW (decoupled weight decay) + gradient clipping + LR schedules.

The port of ``repro.train.optimizer``, with its constants and defaults.
States are plain trees (nested dicts of tensors, and the ``AdamWState``
dataclass), so the checkpoint store treats them like parameters.

``adamw_update`` writes the parameters and the state IN PLACE, leaf by
leaf and within a leaf chunk by chunk: the counterpart of the
reference's donation (``jax.jit(step, donate_argnums=(0, 1))``). At
qwen2.5-3b's width the float32 parameters, gradients, ``m`` and ``v``
take 12.3 GB each; new trees would need as much again. The step, the
learning rate and the global norm stay device tensors: nothing here
reads a value back to the host.

The arithmetic is the reference's as XLA:CPU compiles it (measured on
jax 0.9.0, ROADMAP "Bitwise hazards"): the moments are contracted to
``fma(b1, m, (1 - b1) * g)`` and ``fma(b2, v, (1 - b2) * g*g)``, the
bias corrections fold into ``m2 / (c1 * (sqrt(v2 / c2) + eps))``, the
decay and the step are ``fma(p, wd, q)`` and ``fma(-lr, delta, p)``.
``torch.add(c, b, alpha=a)`` (a Python float) and ``torch.addcmul(c,
a, b)`` compute ``fma(a, b, c)`` (one rounding) on the CPU; on the card
nvcc contracts their ``c + a * b`` by default, which nothing there
holds bitwise. Denormal gradients and products are flushed to
zero, as XLA:CPU reads and writes them; the square root is correctly
rounded (``_num.sqrt_f32``), as XLA:CPU's is and torch's vectorized CPU
kernel is not. The moments and the parameters come out bitwise the
reference's except where the bias corrections' float32 ``pow`` differs
(neither library's is correctly rounded): within a few ulps there
(``tests/test_torch_train_optimizer.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch._num import LEAST_NORMAL, sqrt_f32
from repro_torch.models.common import tree_items, tree_map

# elements of a leaf updated at once: bounds the update's temporaries
# (a few float32 chunks, 256 MB each) whatever the leaf's size
CHUNK = 1 << 26


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor       # 0-dim int32, on the parameters' device
    m: Any
    v: Any


def _device_of(tree) -> torch.device:
    return next(leaf for _, leaf in tree_items(tree)).device


def adamw_init(params) -> AdamWState:
    """Zero moments (float32) and step 0 beside ``params``, on their
    device (``meta`` too: the prototype of a restore)."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device_of(params)),
                      m=zeros, v=tree_map(torch.clone, zeros))


def _const(c: float, dev) -> torch.Tensor:
    """A float32 constant as a 0-dim tensor on ``dev`` (a fill, not a
    host-to-device copy)."""
    return torch.full((), c, dtype=torch.float32, device=dev)


# the largest float32 denormal: ``hardshrink`` zeroes |x| <= it (and
# keeps NaN), one kernel where a mask and a fill take three
_LARGEST_DENORMAL = float(np.nextafter(np.float32(LEAST_NORMAL),
                                       np.float32(0)))


def _flush_(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its float32 denormals set to zero, in place."""
    return torch.ops.aten.hardshrink.out(t, _LARGEST_DENORMAL, out=t)


def _leaf(g, m, v, p, k: dict):
    """One chunk of one leaf (flat views; ``m``, ``v`` and ``p`` are
    written in place)."""
    g = _flush_(g.to(torch.float32, copy=True))
    x = _flush_(g.mul(k["1-b1"]))                  # (1 - b1) * g
    torch.add(x, m, alpha=k["b1"], out=m)          # fma(b1, m, x)
    _flush_(m)
    x = _flush_(_flush_(g.mul_(g)).mul_(k["1-b2"]))   # (1 - b2) * g*g
    torch.add(x, v, alpha=k["b2"], out=v)
    _flush_(v)
    q = sqrt_f32(torch.div(v, k["c2"])).add_(k["eps"]).mul_(k["c1"])
    torch.div(m, q, out=q)
    torch.add(q, p, alpha=k["wd"], out=q)          # fma(wd, p, q)
    torch.addcmul(p, k["-lr"], q, out=p)           # fma(-lr, q, p)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step: ``params``, ``state.m``, ``state.v`` and
    ``state.step`` are updated in place and returned as
    ``(params, state)``. ``grads`` (float32 or bfloat16, same tree as
    ``params``) is left as it is; ``lr`` is a float or a 0-dim float32
    tensor. At most one chunk's temporaries are alive at a time."""
    dev = state.step.device
    state.step.add_(1)
    t = state.step.to(torch.float32)
    k = {"b1": b1, "1-b1": 1 - b1, "b2": b2, "1-b2": 1 - b2, "eps": eps,
         "wd": weight_decay,
         "c1": 1.0 - torch.pow(_const(b1, dev), t),
         "c2": 1.0 - torch.pow(_const(b2, dev), t)}
    lr = lr if isinstance(lr, torch.Tensor) else _const(lr, dev)
    k["-lr"] = -lr.to(torch.float32)
    ms, vs, ps = (dict(tree_items(tr)) for tr in (state.m, state.v, params))
    for path, g in tree_items(grads):
        p, m, v = ps[path], ms[path], vs[path]
        if p.dtype != torch.float32:
            raise TypeError(f"{'/'.join(path)}: AdamW updates float32 "
                            f"master weights, not {p.dtype}")
        gf, mf, vf, pf = (a.reshape(-1) if a is g else a.view(-1)
                          for a in (g, m, v, p))
        for a in range(0, pf.numel(), CHUNK):
            sl = slice(a, a + CHUNK)
            _leaf(gf[sl], mf[sl], vf[sl], pf[sl], k)
    return params, state


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` IN PLACE to a global norm of at most ``max_norm``;
    returns (grads, the global norm before), the norm a 0-dim device
    tensor. The squares are summed per leaf and the sums added in the
    reference's leaf order (keys sorted). A bfloat16 leaf is scaled in
    float32 and rounded back, as the reference does."""
    total = None
    for _, g in tree_items(grads):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    gn = sqrt_f32(total)
    scale = torch.clamp(_const(max_norm, gn.device) /
                        torch.clamp(gn, min=1e-9), max=1.0)
    for _, g in tree_items(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return grads, gn


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``floor * peak_lr`` at ``total``; ``step`` a 0-dim integer tensor,
    the rate a 0-dim float32 tensor on its device.

    The reference's expression as XLA:CPU compiles it: its constants
    fold in float32 (``peak_lr * t / warmup`` becomes ``t * (peak_lr /
    warmup)``; the division by ``total - warmup`` a product with the
    reciprocal), and ``0.45 * (1 + cos) + 0.1`` is one FMA. Its float32
    ``cos`` is not correctly rounded: the cosine here is taken in float64
    and rounded, which agrees with it more often than torch's float32
    ``cos`` (within an ulp where they differ)."""
    f32 = np.float32
    t = step.to(torch.float32)
    warm = t * float(f32(peak_lr) / f32(max(warmup, 1)))
    frac = torch.clamp((t - warmup) * float(f32(1) / f32(max(total - warmup,
                                                              1))),
                       0.0, 1.0)
    c = torch.cos((frac * float(f32(math.pi))).double()).float()
    dev = t.device
    cos = torch.addcmul(_const(floor, dev), c + 1,
                        _const((1 - floor) * 0.5, dev)) * peak_lr
    return torch.where(t < warmup, warm, cos)
