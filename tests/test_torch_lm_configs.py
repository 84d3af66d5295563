"""The port's LM configs, token pipeline and parameter conversion against
the JAX package, on the CPU.

For all ten archs, full and smoke: every ``ModelConfig`` field equals
the reference's, and so do ``param_count``, ``active_param_count`` and
each layer's window. ``make_batch`` gives the reference's arrays (the
same numpy generator), ``input_specs`` its shapes and dtypes, and
``TokenPipeline`` its batches after a skip. ``params_from_arrays`` then
``params_to_arrays`` gives back every leaf bitwise, on each arch's
parameter tree and on the reference's own ``model.init(PRNGKey(0))``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import tokens as ref_tokens
from repro.models import build_model as ref_build
from repro.models.common import init_shapes as ref_init_shapes
from repro_torch import configs, convert
from repro_torch.data import tokens
from repro_torch.models import build_model
from repro_torch.models.common import init_shapes, tree_items

CPU = "cpu"
CASES = [(a, s) for a in ref_configs.ARCHS for s in (False, True)]
IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CASES]


def _np_dtype(dt) -> np.dtype:
    return np.dtype(str(dt).replace("torch.", ""))


def test_arch_lists_match():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.all_arch_ids() == ref_configs.all_arch_ids()


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_config_and_counts_match(arch, smoke):
    want = ref_configs.get_config(arch.replace("_", "-"), smoke=smoke)
    got = configs.get_config(arch.replace("_", "-"), smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert [got.window_for_layer(i) for i in range(got.n_layers)] == \
        [want.window_for_layer(i) for i in range(want.n_layers)]
    assert got.cdtype == getattr(torch, want.compute_dtype)
    assert init_shapes(got) == ref_init_shapes(want)


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_batches_and_specs_match(arch, smoke):
    rc = ref_configs.get_config(arch, smoke=smoke)
    pc = configs.get_config(arch, smoke=smoke)
    # full configs at a small batch; the VLM's sequence holds its patches
    seq = (pc.n_patches + 16) if pc.patch_input else 48
    if smoke:
        want = ref_tokens.make_batch(rc, 2, seq, seed=3, step=5)
        got = tokens.make_batch(pc, 2, seq, seed=3, step=5, device=CPU)
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
    specs = tokens.input_specs(pc, 8, 4096 if not smoke else seq)
    ref_specs = ref_tokens.input_specs(rc, 8, 4096 if not smoke else seq)
    assert set(specs) == set(ref_specs)
    for k, sd in ref_specs.items():
        assert specs[k].device.type == "meta"
        assert tuple(specs[k].shape) == tuple(sd.shape)
        assert _np_dtype(specs[k].dtype) == np.dtype(sd.dtype)


def test_token_pipeline_matches():
    rc = ref_configs.get_config("phi-3-vision-4.2b", smoke=True)
    pc = configs.get_config("phi-3-vision-4.2b", smoke=True)
    want = ref_tokens.TokenPipeline(rc, 2, 24, seed=7, start_step=2)
    got = tokens.TokenPipeline(pc, 2, 24, seed=7, start_step=2, device=CPU)
    for skip in (None, 9):
        if skip is not None:
            want.skip_to(skip)
            got.skip_to(skip)
        for _ in range(2):
            w, g = next(want), next(got)
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert got.step == want.step == 11


def _same_tree(got: dict, want: dict):
    g, w = dict(tree_items(got)), dict(tree_items(want))
    assert set(g) == set(w)
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        np.testing.assert_array_equal(g[path], w[path], err_msg=str(path))


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_params_round_trip_bitwise(arch):
    """Every leaf of the arch's tree (random bits, NaNs and denormals
    included) through ``params_from_arrays`` and back."""
    rng = np.random.default_rng(0)
    is_shape = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(i, int) for i in x)
    tree = jax.tree_util.tree_map(
        lambda s: rng.integers(0, 2 ** 32, s, dtype=np.uint32).view(
            np.float32), ref_init_shapes(ref_configs.get_config(
                arch, smoke=True)), is_leaf=is_shape)
    params = convert.params_from_arrays(tree, device=CPU)
    for path, leaf in tree_items(params):
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
    back = convert.params_to_arrays(params)
    for (path, a), (_, b) in zip(tree_items(back), tree_items(tree)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=str(path))


def test_reference_init_carries_across():
    """The reference's own ``model.init(PRNGKey(0))``: the port takes it
    leaf for leaf (and its bf16 cache arrays bit for bit), and the
    port's ``init`` builds the same tree of shapes."""
    cfg = ref_configs.get_config("qwen2.5-3b", smoke=True)
    ref_params = ref_build(cfg).init(jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(np.asarray, ref_params)
    params = convert.params_from_arrays(ref_params, device=CPU)
    _same_tree(convert.params_to_arrays(params), want)
    mine = build_model(configs.get_config("qwen2.5-3b", smoke=True)).init(
        0, device=CPU)
    assert {p: tuple(v.shape) for p, v in tree_items(mine)} == \
        {p: v.shape for p, v in tree_items(want)}
    bf = jnp.asarray(np.linspace(-3, 3, 37, dtype=np.float32), jnp.bfloat16)
    t = convert.params_from_arrays(np.asarray(bf), device=CPU)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(bf).view(np.int16))
