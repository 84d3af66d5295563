"""The port's gradient compression against the JAX package, on the CPU
(the twin of tests/test_compress.py).

``quantize_int8``/``dequantize_int8`` bitwise the jitted reference's over
seeded sizes and scales, with the reference's per-block error bound;
``ef_compress_grads`` at four gloo ranks (``tests/_dist_worker.py``'s
``compress`` scenario, each rank one worker) bitwise the reference's
``jax.jit(jax.vmap(..., axis_name="pod"))`` in every round, synced
gradients and residuals; the residual ``g32 - q * smax`` is contracted
to one FMA by XLA:CPU (checked here on the reference's first round);
and the error-feedback mean converges, as the reference's test asks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_worker as W
from repro.train import compress as RC
from repro_torch.train import compress as C

torch.set_num_threads(1)
# (size, scale exponent, seed): sizes 1..2000 (one, several and padded
# blocks), scales 1e-3..1e2
QUANT_CASES = [(int(n), int(e), s) for s, (n, e) in enumerate(zip(
    np.random.default_rng(7).integers(1, 2001, 18),
    np.tile(np.arange(-3, 3), 3)))] + [(1, 0, 18), (256, -3, 19),
                                       (257, 2, 20), (2000, 1, 21)]


def _grad(n: int, e: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10.0 ** e).astype(np.float32)


@pytest.mark.parametrize("n,e,seed", QUANT_CASES,
                         ids=[f"n{n}-1e{e}" for n, e, _ in QUANT_CASES])
def test_quantize_bitwise_and_bounded(n, e, seed):
    g = _grad(n, e, seed)
    rq, rs = jax.jit(RC.quantize_int8)(jnp.asarray(g))
    rback = jax.jit(RC.dequantize_int8, static_argnums=2)(rq, rs, g.shape)
    q, s = C.quantize_int8(torch.from_numpy(g))
    back = C.dequantize_int8(q, s, g.shape)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(rs).view(np.int32))
    np.testing.assert_array_equal(back.numpy().view(np.int32),
                                  np.asarray(rback).view(np.int32))
    # the reference's bound: per block, error <= scale / 2 = max / 254
    pad = (-n) % C.BLOCK
    blocks = np.pad(g, (0, pad)).reshape(-1, C.BLOCK)
    bound = np.abs(blocks).max(axis=1) / 254.0 + 1e-9
    err = np.pad(np.abs(back.numpy() - g), (0, pad)).reshape(-1, C.BLOCK)
    assert (err.max(axis=1) <= bound * 1.01).all()


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """{"ref": the reference's outputs, "ranks": each rank's}."""
    out = tmp_path_factory.mktemp("compress")
    ref, ranks = W.spawn("compress", ["4pod"], str(out), timeout=240)()[
        "4pod"]
    return {"ref": ref, "ranks": ranks}


@pytest.mark.parametrize("what", ["synced", "res"])
def test_ef_compress_matches_the_reference_at_four_ranks(synced, what):
    for i in range(W.COMPRESS_ROUNDS):
        for leaf in W.compress_grads():
            want = synced["ref"][f"{what}/{leaf}/{i}"]
            for r, got in enumerate(synced["ranks"]):
                got = got[f"{what}/{leaf}/{i}"]
                assert got.dtype == np.float32, (what, leaf, i, r)
                np.testing.assert_array_equal(
                    got.view(np.int32), want[r].view(np.int32),
                    err_msg=f"{what}/{leaf} round {i} rank {r}")


def test_residual_is_one_fma(synced):
    """The reference's first-round residual (from zero residuals) is
    ``fma(-q, smax, g)``; ``g - q * smax`` rounded twice differs from it
    somewhere, so the port's fused form is the one that matches."""
    true = W.compress_grads()["w"]
    blocks = np.pad(true.reshape(W.WORLD, -1),
                    ((0, 0), (0, (-true[0].size) % C.BLOCK))).reshape(
        W.WORLD, -1, C.BLOCK)
    scale = np.maximum(np.abs(blocks).max(axis=2, keepdims=True) *
                       (np.float32(1) / np.float32(127)), np.float32(1e-12))
    smax = scale.max(axis=0)
    q = np.clip(np.round(blocks / smax), -127, 127).astype(np.float32)
    fused = (blocks.astype(np.float64) - q.astype(np.float64) *
             smax.astype(np.float64)).astype(np.float32)
    twice = blocks - (q * smax).astype(np.float32)
    n = true[0].size
    want = synced["ref"]["res/w/0"].reshape(W.WORLD, -1)
    np.testing.assert_array_equal(fused.reshape(W.WORLD, -1)[:, :n], want)
    assert (twice.reshape(W.WORLD, -1)[:, :n] != want).any()


def test_error_feedback_mean_converges(synced):
    """With EF, the time-average of the compressed syncs converges to the
    true mean gradient (EF-SGD), on every rank."""
    true = W.compress_grads()
    for leaf, g in true.items():
        for got in synced["ranks"]:
            avg = np.mean([got[f"synced/{leaf}/{i}"]
                           for i in range(W.COMPRESS_ROUNDS)], axis=0)
            assert np.abs(avg - g.mean(axis=0)).max() < 0.05, leaf


def test_residual_shapes():
    params = {"w": torch.zeros((3, 4)), "b": torch.zeros((7,))}
    res = C.init_residuals(params)
    assert res["w"].shape == (3, 4) and res["b"].shape == (7,)
    assert all(r.dtype == torch.float32 for r in res.values())
