"""LM serving: prefill / decode steps + a batched session.

The port of ``repro.serve.api``. The decode step is ONE token for the
whole batch. The steps run eagerly (the reference jits them); meshed
serving (``mesh=``, ``rules=``: FSDP x TP parameters, sharded caches)
is ROADMAP item 19d, and those arguments are accepted only as None.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._num import resolve_device
from repro_torch.models.common import tree_items


def _unmeshed(mesh, rules):
    if mesh is not None or rules is not None:
        raise ValueError("meshed LM serving (mesh=, rules=) is not ported "
                         "yet (ROADMAP item 19d); pass None")


def _on(params, dev: torch.device):
    """Raise unless every parameter lies on ``dev``."""
    for path, leaf in tree_items(params):
        if leaf.device.type != dev.type:
            raise ValueError(f"parameter {'/'.join(path)} is on "
                             f"{leaf.device}, not {dev}")


def make_prefill(model, *, mesh=None, rules=None,
                 max_len: Optional[int] = None):
    _unmeshed(mesh, rules)

    def prefill(params, batch):
        return model.prefill(params, batch, max_len=max_len)

    return prefill


def make_decode(model, *, mesh=None, rules=None):
    _unmeshed(mesh, rules)

    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def generate(model, params, batch, *, steps: int, mesh=None, rules=None,
             max_len: Optional[int] = None, greedy: bool = True,
             rng: Optional[torch.Generator] = None, device="cuda"):
    """Prefill + `steps` greedy/sampled tokens. Returns (B, steps) int32.

    ``batch`` holds tensors or arrays (moved to ``device``); ``params``
    must already be there. With ``greedy=False`` and a
    ``torch.Generator`` as ``rng``, tokens are drawn from the softmax of
    the logits (not bitwise the reference's ``jax.random.categorical``).
    """
    _unmeshed(mesh, rules)
    dev = resolve_device(device)
    _on(params, dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    cfg = model.cfg
    prompt_len = batch["tokens"].shape[1] + (
        cfg.n_patches if getattr(cfg, "patch_input", False) and
        "patches" in batch else 0)
    max_len = max_len or (prompt_len + steps)
    prefill = make_prefill(model, max_len=max_len)
    decode = make_decode(model)
    logits, cache = prefill(params, batch)
    # the position lives on the device: a host int would be copied to
    # the device at every step, which waits for the stream
    pos = torch.tensor(prompt_len, dtype=torch.int32, device=dev)
    toks = []
    tok = _greedy(logits)
    for _ in range(steps):
        toks.append(tok)
        logits, cache = decode(params, cache, tok, pos)
        pos = pos + 1
        if greedy or rng is None:
            tok = _greedy(logits)
        else:
            probs = torch.softmax(logits[:, -1].float(), dim=-1)
            tok = torch.multinomial(probs, 1, generator=rng).to(torch.int32)
    return torch.cat(toks, dim=1)


class ServeSession:
    """Continuous batched serving: fixed-slot batch, per-slot positions.

    Simplified continuous batching: the decode step always runs the
    full fixed batch at one shared position (the largest slot's).
    """

    def __init__(self, model, params, batch_size: int, max_len: int,
                 mesh=None, rules=None, *, device="cuda"):
        _unmeshed(mesh, rules)
        self.device = resolve_device(device)
        _on(params, self.device)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.batch = batch_size
        self.pos = torch.zeros((batch_size,), dtype=torch.int32,
                               device=self.device)
        if hasattr(model, "init_cache"):
            self.cache = model.init_cache(batch_size, max_len,
                                          device=self.device)
        else:
            self.cache = model.init_state(batch_size, device=self.device)
        self._decode = make_decode(model)

    def step(self, tokens):
        """tokens (B, 1) -> logits (B, 1, V); advances all slots."""
        tokens = torch.as_tensor(tokens).to(self.device)
        pos = torch.max(self.pos)
        logits, self.cache = self._decode(self.params, self.cache, tokens,
                                          pos)
        self.pos = self.pos + 1
        return logits
