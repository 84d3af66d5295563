"""Port parity: keys, Morton codes and the numerical helpers, bitwise
against the JAX package on the same numpy-seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import keys as JK
from repro_torch import _num
from repro_torch.core import keys as TK

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

BOUNDS = [(0.0, 0.0, 1.0, 1.0), (0.0123, -0.5, 0.98761, 1.25),
          (0.1, 0.2, 0.1 + 1e-7, 0.9)]


def _coords(seed, n=4096):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.2, 1.3, (n, 2)).astype(np.float32)
    c[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0.5],
             [np.nextafter(np.float32(1), np.float32(0))] * 2,
             [-1e-9, 2.0], [0.1, 0.9]]
    return c[:, 0], c[:, 1]


@pytest.mark.parametrize("bounds", BOUNDS)
@pytest.mark.parametrize("kind,bits", [("morton", 11), ("morton", 12),
                                       ("morton", 4), ("x", 11),
                                       ("y", 16)])
def test_make_keys_bitwise(kind, bits, bounds):
    x, y = _coords(bits)
    js = JK.KeySpec(kind=kind, bits_per_dim=bits, bounds=bounds)
    ts = TK.KeySpec(kind=kind, bits_per_dim=bits, bounds=bounds)
    want = np.asarray(JK.make_keys(jnp.asarray(x), jnp.asarray(y), js))
    got = TK.make_keys(torch.from_numpy(x), torch.from_numpy(y), ts)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(TK.keys_to_f32(got).numpy(),
                          np.asarray(JK.keys_to_f32(jnp.asarray(want))))
    assert ts.key_bits == js.key_bits and ts.sentinel == js.sentinel


@pytest.mark.parametrize("bounds", BOUNDS[:2])
def test_rect_key_range_bitwise(bounds):
    rng = np.random.default_rng(5)
    lo = rng.uniform(-0.1, 1.0, (500, 2))
    wh = rng.uniform(0, 0.3, (500, 2))
    rects = np.concatenate([lo, lo + wh], 1).astype(np.float32)
    js = JK.KeySpec(bounds=bounds)
    ts = TK.KeySpec(bounds=bounds)
    jlo, jhi = JK.rect_key_range(jnp.asarray(rects), js)
    tlo, thi = TK.rect_key_range(torch.from_numpy(rects), ts)
    assert np.array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))
    assert np.array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))


def test_morton_encode_bitwise():
    rng = np.random.default_rng(1)
    qx = rng.integers(0, 1 << 16, 10000)
    qy = rng.integers(0, 1 << 16, 10000)
    want = np.asarray(JK.morton_encode(jnp.asarray(qx, jnp.uint32),
                                       jnp.asarray(qy, jnp.uint32)))
    got = TK.morton_encode(torch.from_numpy(qx), torch.from_numpy(qy))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def _samples(seed, n=1 << 16):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, n).astype(np.float32) *
            np.float32(10.0) ** rng.integers(-3, 3, n).astype(np.float32)
            for _ in range(3)]


def test_fma_f32_matches_jitted_distance():
    """dx*dx + dy*dy under jit (XLA:CPU contracts it) == fma_f32."""
    dx, dy, _ = _samples(0)
    want = np.asarray(jax.jit(lambda a, b: a * a + b * b)(dx, dy))
    a, b = torch.from_numpy(dx), torch.from_numpy(dy)
    got = _num.fma_f32(a, a, b * b).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_f32_matches_jitted_interpolation():
    """p0 + t*(p1 - p0) under jit == fma_f32(t, p1 - p0, p0)."""
    t, p0, p1 = _samples(1)
    t = np.abs(t) / np.abs(t).max()
    want = np.asarray(jax.jit(lambda t, a, b: a + t * (b - a))(t, p0, p1))
    tt, a, b = map(torch.from_numpy, (t, p0, p1))
    got = _num.fma_f32(tt, b - a, a).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_f32_is_single_rounding():
    """a*b = 1 + 2^-11 + 2^-24 sits exactly on a float32 midpoint; a tiny
    c decides the rounding. Rounding the float64 sum to float32 (double
    rounding) loses c; a true FMA, and fma_f32, keep it."""
    a = b = np.float32(1 + 2 ** -12)
    up = np.float32(1 + 2 ** -11 + 2 ** -23)
    down = np.float32(1 + 2 ** -11)
    for c, want in [(2.0 ** -80, up), (-2.0 ** -80, down), (0.0, down)]:
        got = _num.fma_f32(torch.tensor([a]), torch.tensor([b]),
                           torch.tensor([np.float32(c)]))[0].item()
        assert np.float32(got) == want, c
    naive = np.float32(np.float64(a) * np.float64(b) + 2.0 ** -80)
    assert naive == down          # the hazard this helper avoids


def test_stable_topk_matches_lax_top_k():
    rng = np.random.default_rng(2)
    v = rng.integers(0, 6, (64, 200)).astype(np.float32)   # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(v), 17)
    got_v, got_i = _num.stable_topk(torch.from_numpy(v), 17)
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))


def test_resolve_device_cpu():
    assert _num.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        _num.resolve_device("meta")
