"""The train step: microbatching, remat, clipping, AdamW.

The port of ``repro.train.step`` on one device. Autograd computes the
backward pass (each model layer checkpointed in ``train_loss``). The
step runs eagerly where the reference jits it; with ``donate`` (the
reference's ``donate_argnums=(0, 1)``) it updates ``params`` and
``opt_state`` in place, which at qwen2.5-3b's width is what lets the
float32 state fit on one card (``optimizer.py``).

Microbatching: a loop over microbatch slices accumulating float32
gradients, then scaled by 1/n_micro (the reference's ``lax.scan``),
which keeps activation peaks ~1/n_micro while the optimizer sees the
whole batch.

Meshed training (``mesh=``, ``rules=``: FSDP x TP parameters, sharded
batches, ``shard_in``) is ROADMAP item 19d; those arguments are accepted
only as None.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_items, tree_map
from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                         clip_by_global_norm,
                                         cosine_schedule)


def _unmeshed(mesh, rules):
    if mesh is not None or rules is not None:
        raise ValueError("meshed training (mesh=, rules=) is not ported "
                         "yet (ROADMAP item 19d); pass None")


def _tree(paths, leaves) -> dict:
    out = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _copy_state(params, opt_state: AdamWState):
    return tree_map(torch.clone, params), AdamWState(
        step=opt_state.step.clone(), m=tree_map(torch.clone, opt_state.m),
        v=tree_map(torch.clone, opt_state.v))


class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``, every metric a 0-dim float32 tensor on the
    device (nothing is read back to the host). ``shard_in`` is None: the
    unmeshed step takes its inputs as they are."""

    shard_in = None

    def __init__(self, model, *, n_micro: int, peak_lr: float,
                 warmup: int, total_steps: int, max_grad_norm: float,
                 donate: bool, bf16_weights: bool):
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        self.model = model
        self.n_micro = n_micro
        self.peak_lr, self.warmup, self.total_steps = (peak_lr, warmup,
                                                       total_steps)
        self.max_grad_norm = max_grad_norm
        self.donate = donate
        self.bf16_weights = bf16_weights

    def _value_and_grad(self, params, batch):
        """(loss, {path: gradient}) of ``train_loss`` at ``params``."""
        items = list(tree_items(params))
        paths = [p for p, _ in items]
        xs = [leaf.detach().requires_grad_(True) for _, leaf in items]
        with torch.enable_grad():
            loss = self.model.train_loss(_tree(paths, xs), batch)
            gs = torch.autograd.grad(loss, xs, materialize_grads=True)
        return loss.detach(), dict(zip(paths, gs))

    def grads(self, params, batch):
        """(loss, gradients) of one step on ``batch``, microbatched:
        float32 gradients summed over the microbatches, then loss and
        gradients scaled by 1/n_micro. With one microbatch a gradient
        has its leaf's dtype (bfloat16 under ``bf16_weights``)."""
        if self.bf16_weights:
            # cast ONCE per step, outside the microbatch loop; gradients
            # flow to the bf16 tree, AdamW keeps the float32 master
            params = tree_map(
                lambda p: p.detach().to(torch.bfloat16)
                if p.dtype == torch.float32 and p.ndim >= 2 else p, params)
        if self.n_micro == 1:
            loss, g = self._value_and_grad(params, batch)
            return loss, _tree(g, g.values())
        n = self.n_micro
        b = max(a.shape[0] for a in batch.values() if a.ndim >= 1)
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of n_micro {n}")
        mb = b // n
        acc = {path: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
               for path, p in tree_items(params)}
        acc_loss = None
        for i in range(n):
            mbatch = {k: a[i * mb:(i + 1) * mb]
                      if a.ndim >= 1 and a.shape[0] == b else a
                      for k, a in batch.items()}
            loss, g = self._value_and_grad(params, mbatch)
            for path, x in g.items():
                acc[path].add_(x.to(torch.float32))
            del g
            acc_loss = loss if acc_loss is None else acc_loss + loss
        scale = 1.0 / n
        for a in acc.values():
            a.mul_(scale)
        return acc_loss * scale, _tree(acc, acc.values())

    def __call__(self, params, opt_state: AdamWState, batch):
        if not self.donate:
            params, opt_state = _copy_state(params, opt_state)
        loss, grads = self.grads(params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
            lr = cosine_schedule(opt_state.step, peak_lr=self.peak_lr,
                                 warmup=self.warmup,
                                 total=self.total_steps)
            params, opt_state = adamw_update(grads, opt_state, params,
                                             lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}


def make_train_step(model, *, mesh=None, rules=None, n_micro: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, max_grad_norm: float = 1.0,
                    donate: bool = True, bf16_weights: bool = False):
    """The reference's ``make_train_step`` on one device: a ``TrainStep``.

    ``donate`` updates ``params`` and ``opt_state`` in place; without,
    they are left as they were and the step returns new trees.
    ``bf16_weights`` casts the float32 leaves of rank >= 2 to bfloat16
    once per step and differentiates with respect to the cast tree."""
    _unmeshed(mesh, rules)
    return TrainStep(model, n_micro=n_micro, peak_lr=peak_lr,
                     warmup=warmup, total_steps=total_steps,
                     max_grad_norm=max_grad_norm, donate=donate,
                     bf16_weights=bf16_weights)
