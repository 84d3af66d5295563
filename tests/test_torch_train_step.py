"""One train step of the port against the JAX package's ``step.jit``, on
the CPU.

qwen2.5 and deepseek-v2 (MoE, MLA, a dense first layer) at their smoke
size and float32 compute, ``n_micro`` 1 and 2, ``bf16_weights`` off and
on, from the same carried weights and a fresh ``adamw_init`` (warmup 0,
so the first step moves the weights). The loss, ``grad_norm`` and ``lr``
within the gradient tolerances (``_lm_train.py``; bf16 weights: the bf16
ones). The updated parameters: every element of every leaf within
``2.05 * lr`` of the reference's, and all but ``FAR_SHARE`` of the
elements (counted over the tree: one element of a 4,096-element leaf
is already 2.4e-4 of it) within ``lr * 1e-3``. At step 1 AdamW's
update is ``g / (|g| + eps)``, about sign(g): a gradient near zero can
take the other sign in the other package and move its element by up to
``2 * lr``. Measured: 6, 6, 6 and 2 such elements of qwen's 131,648
(n_micro 1, 2, then with bf16 weights), 12, 12, 26 and 3 of deepseek's
338,976.

Then the step's contract: ``donate=True`` updates the given trees in
place, ``donate=False`` leaves them bitwise as they were; ``mesh=`` and
``rules=`` are refused (ROADMAP item 19d).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train as LT
from repro.models import build_model as ref_build
from repro.train import adamw_init as ref_adamw_init
from repro.train import make_train_step as ref_make_train_step
from repro.data.tokens import make_batch as ref_batch
from repro_torch import convert
from repro_torch.data.tokens import make_batch
from repro_torch.models import build_model
from repro_torch.models.common import tree_items, tree_map
from repro_torch.train import adamw_init, make_train_step
from test_torch_lm_models import ref_weights

torch.set_num_threads(1)
BATCH, SEQ = 4, 32
PEAK = 1e-3
FAR_SHARE = 1e-4
KW = dict(peak_lr=PEAK, warmup=0, total_steps=20)
CASES = [pytest.param(a, n, bf, id=f"{a}-micro{n}{'-bf16w' if bf else ''}")
         for a in ("qwen2_5_3b", "deepseek_v2_lite_16b")
         for n in (1, 2) for bf in (False, True)]


@pytest.mark.parametrize("arch,n_micro,bf16_weights", CASES)
def test_step_matches_the_reference(arch, n_micro, bf16_weights):
    rc, pc = LT.configs(arch, "float32")
    jp, tp = ref_weights(rc)
    ref_step = ref_make_train_step(ref_build(rc), n_micro=n_micro,
                                   donate=False, bf16_weights=bf16_weights,
                                   **KW)
    rp, _, rm = ref_step.jit(jp, ref_adamw_init(jp),
                             ref_batch(rc, BATCH, SEQ, seed=1))
    step = make_train_step(build_model(pc), n_micro=n_micro,
                           bf16_weights=bf16_weights, **KW)
    pp, st, pm = step(tp, adamw_init(tp), make_batch(pc, BATCH, SEQ, seed=1,
                                                     device="cpu"))
    assert int(st.step) == 1
    for k in ("loss", "grad_norm", "lr"):
        assert pm[k].shape == () and pm[k].dtype == torch.float32, k
    assert float(pm["lr"]) == float(rm["lr"]) == np.float32(PEAK)
    rtol = LT.BF16_RTOL if bf16_weights else LT.F32_LOSS_RTOL
    assert abs(float(pm["loss"]) / float(rm["loss"]) - 1) <= rtol
    rtol = LT.BF16_RTOL if bf16_weights else LT.F32_GRAD_RTOL
    assert abs(float(pm["grad_norm"]) / float(rm["grad_norm"]) - 1) <= rtol
    lr = float(rm["lr"])
    want = {tuple(k.key for k in kp): np.asarray(v, np.float64)
            for kp, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    far = total = 0
    for path, got in tree_items(pp):
        err = np.abs(got.double().numpy() - want[path])
        assert err.max() <= 2.05 * lr, (path, err.max() / lr)
        far += int((err > lr * 1e-3).sum())
        total += err.size
    assert far <= FAR_SHARE * total, (far, total)


def _qwen():
    _, pc = LT.configs("qwen2_5_3b", "float32")
    model = build_model(pc)
    return pc, model, model.init(0, device="cpu")


def test_donate_updates_in_place():
    pc, model, params = _qwen()
    opt = adamw_init(params)
    before = tree_map(torch.clone, params)
    ptrs = [v.data_ptr() for _, v in tree_items(params)]
    step = make_train_step(model, **KW)
    p2, o2, _ = step(params, opt, make_batch(pc, BATCH, SEQ, seed=1,
                                             device="cpu"))
    assert p2 is params and o2 is opt and int(opt.step) == 1
    assert ptrs == [v.data_ptr() for _, v in tree_items(params)]
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(params), tree_items(before)))
    assert all(bool(v.any()) for _, v in tree_items(opt.v) if v.ndim > 1)


def test_no_donate_leaves_the_inputs_as_they_were():
    pc, model, params = _qwen()
    opt = adamw_init(params)
    batch = make_batch(pc, BATCH, SEQ, seed=1, device="cpu")
    step = make_train_step(model, **KW)
    params, opt, _ = step(params, opt, batch)        # a state past step 0
    snap = [t.clone() for t in (opt.step,)] + [
        v.clone() for tree in (params, opt.m, opt.v)
        for _, v in tree_items(tree)]
    keep = make_train_step(model, donate=False, **KW)
    p2, o2, m2 = keep(params, opt, batch)
    now = [opt.step] + [v for tree in (params, opt.m, opt.v)
                        for _, v in tree_items(tree)]
    for a, b in zip(now, snap):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert p2 is not params and int(o2.step) == 2 and int(opt.step) == 1
    # the same step, donated, from copies: the same values
    d2, od, md = step(tree_map(torch.clone, params),
                      convert.opt_state_from_arrays(
                          convert.opt_state_to_arrays(opt), device="cpu"),
                      batch)
    assert torch.equal(md["loss"], m2["loss"])
    for (_, a), (_, b) in zip(tree_items(d2), tree_items(p2)):
        assert torch.equal(a, b)


def test_meshed_training_is_refused():
    _, model, _ = _qwen()
    for kw in ({"mesh": object()}, {"rules": object()}):
        with pytest.raises(ValueError, match="19d"):
            make_train_step(model, **kw)


def test_opt_state_carries_across():
    """The reference's ``adamw_init`` and one step's state into the port
    and back, leaf for leaf."""
    rc, _ = LT.configs("qwen2_5_3b", "float32")
    jp, _ = ref_weights(rc)
    ref = ref_adamw_init(jp)
    ref = ref.__class__(step=jnp.int32(7), m=jax.tree_util.tree_map(
        lambda a: a + 0.5, ref.m), v=ref.v)
    st = convert.opt_state_from_arrays(ref, device="cpu")
    assert st.step.dtype == torch.int32 and int(st.step) == 7
    back = convert.opt_state_to_arrays(st)
    assert back["step"].dtype == np.int32
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(tree_items(back[name]), tree_items(
                jax.tree_util.tree_map(np.asarray, getattr(ref, name)))):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {path}")
