"""Shared cases of the LM training tests (``test_torch_train_*.py``).

The gradient of ``train_loss`` on the same weights (numpy draws on the
reference's tree, ``test_torch_lm_models.ref_weights``) and the same
batch (``make_batch``, batch 2 x 32 tokens, seed 1) through both
packages: the reference's ``jax.value_and_grad`` under ``jax.jit``, the
port's autograd (``TrainStep.grads``). At float32 compute the loss
agrees within ``F32_LOSS_RTOL`` and each gradient leaf within
``F32_GRAD_RTOL`` of that leaf's largest reference magnitude; at the
archs' own bf16 the loss and the global gradient norm within
``BF16_RTOL``. Then the port alone: ``train_loss`` with each layer
checkpointed under the remat policies ``"none"`` and ``"dots"`` gives
the loss and gradients of the same loss without checkpoints, bitwise,
and ``"dots"`` recomputes no 2-D product in the backward pass.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.data.tokens import make_batch as ref_batch
from repro.models import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.data.tokens import make_batch
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_items
from repro_torch.train import make_train_step
from test_torch_lm_models import ref_weights

BATCH, SEQ = 2, 32
# float32: measured at most 1.5e-7 (loss) and 2.2e-5 (hymba's ln1, a
# sum over the SSD scan) of the leaf's largest magnitude
F32_LOSS_RTOL = 2e-5
F32_GRAD_RTOL = 1e-4
# bf16: measured at most 3.0e-5 (loss) and 1.2e-3 (the global norm)
BF16_RTOL = 2.0 ** -4
# the families whose train_loss takes the remat policy (rwkv6's plain
# jax.checkpoint recomputes everything; enc-dec has no remat)
POLICY_FAMILIES = ("transformer", "hymba")


def configs(arch: str, dtype: str):
    """(the reference's config, the port's) at the smoke size and
    ``dtype`` compute."""
    return (dataclasses.replace(ref_config(arch, smoke=True),
                                compute_dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=dtype))


def gradients(arch: str, dtype: str):
    """{"ref": (loss, {path: grad}), "port": (loss, {path: grad})}, the
    gradients as float64 numpy."""
    rc, pc = configs(arch, dtype)
    jp, tp = ref_weights(rc)
    loss, g = jax.jit(jax.value_and_grad(ref_build(rc).train_loss))(
        jp, ref_batch(rc, BATCH, SEQ, seed=1))
    ref = {tuple(k.key for k in kp): np.asarray(v, np.float64)
           for kp, v in jax.tree_util.tree_flatten_with_path(g)[0]}
    ploss, pg = make_train_step(build_model(pc)).grads(
        tp, make_batch(pc, BATCH, SEQ, seed=1, device="cpu"))
    port = {path: v.detach().double().numpy() for path, v in tree_items(pg)}
    return {"ref": (float(loss), ref), "port": (float(ploss), port)}


def check_gradients(arch: str, dtype: str):
    got = gradients(arch, dtype)
    (rl, rg), (pl, pg) = got["ref"], got["port"]
    assert set(pg) == set(rg)
    if dtype == "float32":
        assert abs(pl - rl) <= F32_LOSS_RTOL * abs(rl), (pl, rl)
        for path, want in rg.items():
            err = np.abs(pg[path] - want).max()
            assert err <= F32_GRAD_RTOL * max(np.abs(want).max(), 1e-30), (
                path, err, np.abs(want).max())
        return
    assert abs(pl - rl) <= BF16_RTOL * abs(rl), (pl, rl)
    norm = [np.sqrt(sum((v ** 2).sum() for v in g.values()))
            for g in (rg, pg)]
    assert abs(norm[1] - norm[0]) <= BF16_RTOL * norm[0], norm


class _CountMm(TorchDispatchMode):
    """Counts the 2-D products (``aten.mm``/``addmm``) dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in T._DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(model, params, batch):
    items = list(tree_items(params))
    xs = [leaf.detach().requires_grad_(True) for _, leaf in items]
    tree = {}
    for (path, _), x in zip(items, xs):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    loss = model.train_loss(tree, batch)
    with _CountMm() as c:
        gs = torch.autograd.grad(loss, xs, materialize_grads=True)
    return loss.detach(), gs, c.n


def check_remat(arch: str, monkeypatch):
    """No checkpoints, then the "none" and "dots" policies: the same
    loss and gradients bitwise; "dots" recomputes no 2-D product in the
    backward pass, "none" recomputes them all."""
    _, pc = configs(arch, "float32")
    model = build_model(pc)
    params = model.init(0, device="cpu")
    batch = make_batch(pc, BATCH, SEQ, seed=1, device="cpu")
    runs = {}
    with monkeypatch.context() as m:
        m.setattr(T, "checkpoint", lambda fn, *a, **k: fn(*a))
        runs["off"] = _loss_and_grads(model, params, batch)
    try:
        for name in ("none", "dots"):
            T.set_remat_policy(name)
            runs[name] = _loss_and_grads(model, params, batch)
    finally:
        T.set_remat_policy("none")
    for name in ("none", "dots"):
        loss, gs, _ = runs[name]
        assert torch.equal(loss, runs["off"][0]), name
        for a, b in zip(gs, runs["off"][1]):
            assert torch.equal(a, b), name
    mm = {k: v[2] for k, v in runs.items()}
    if pc.family in POLICY_FAMILIES:
        assert mm["dots"] == mm["off"] < mm["none"], mm
    elif pc.family == "rwkv6":
        assert mm["dots"] == mm["none"] > mm["off"], mm
    else:
        assert mm["dots"] == mm["none"] == mm["off"], mm


def arch_cases(archs):
    return [pytest.param(a, d, id=f"{a}-{d}") for a in archs
            for d in ("float32", "bfloat16")]
