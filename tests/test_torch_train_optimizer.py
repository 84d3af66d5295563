"""The port's AdamW, clipping and schedule against the JAX package's,
under ``jax.jit``, on the same numpy trees (CPU).

The jit matters: XLA:CPU contracts the moments and the update to FMAs,
folds the bias corrections into one division and constants into
products, and flushes denormals (ROADMAP "Bitwise hazards"). The port
computes the same arithmetic, so ``adamw_update`` is held bitwise: the
parameters, ``m`` and ``v`` at steps 1, 2 and 10, on gradients with
exact zeros, values near 1e-12, denormals (read as zero) and values
whose products underflow. Its square root is correctly rounded, as
XLA's is and torch's vectorized CPU kernel is not. The bias corrections
``1 - b ** t`` are bitwise too, except at one step each, where the two
libraries' float32 ``pow`` round apart. The global norm sums the leaves
in another order than XLA's reduction: within ``NORM_RTOL``. The
schedule's cosine is XLA's own approximation: within ``ULPS``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as RO
from repro_torch._num import flush_denormals
from repro_torch.models.common import tree_map
from repro_torch.train import optimizer as O

torch.set_num_threads(1)
ULPS = 4
# the global norm: summation orders differ (measured 1.4e-6)
NORM_RTOL = 1e-5
SHAPES = {"embed": (96, 64), "layers": {"w1": (3, 64, 80), "ln": (3, 64)},
          "norm": (64,)}


def tree_np(fn, shapes=SHAPES):
    return {k: tree_np(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in shapes.items()}


def leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def as_torch(tree):
    return {k: as_torch(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)) for k, v in tree.items()}


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def ordered(a):
    """float32 bits as integers that order like the values."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def grads_at(seed: int):
    """Gradients of every kind of magnitude the update meets."""
    rng = np.random.default_rng(seed)

    def one(name, shape):
        g = (rng.standard_normal(shape) * 1e-2).astype(np.float32).ravel()
        n = g.size
        kinds = [0.0, 1e-12, 1e-40, 1e-20, 5e-38]   # zero, tiny, denormal,
        for j, scale in enumerate(kinds):          # g*g and 0.1*g underflow
            sl = slice(j * n // 16, (j + 1) * n // 16)
            g[sl] = rng.standard_normal(g[sl].size) * scale
        return g.reshape(shape)
    return tree_np(one)


def state_at(step: int, seed: int):
    """(params, m, v) as a run would hold them before step ``step``."""
    rng = np.random.default_rng(100 + seed)
    p = tree_np(lambda n, s: (rng.standard_normal(s) * 0.02).astype(
        np.float32) if len(s) > 1 else np.zeros(s, np.float32))
    if step == 1:
        z = tree_np(lambda n, s: np.zeros(s, np.float32))
        return p, z, tree_np(lambda n, s: np.zeros(s, np.float32))
    m = tree_np(lambda n, s: (rng.standard_normal(s) * 1e-3).astype(
        np.float32))
    v = tree_np(lambda n, s: (rng.standard_normal(s) ** 2 * 1e-5).astype(
        np.float32))
    return p, m, v


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 2, 10])
def test_adamw_update_matches(step, gdtype):
    p, m, v = state_at(step, step)
    g = grads_at(step)
    lr = np.float32(1e-3)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, gdtype), g)
    ref_p, ref_s = jax.jit(lambda g, s, p, lr: RO.adamw_update(
        g, s, p, lr=lr))(jg, RO.AdamWState(
            step=jnp.int32(step - 1), m=jax.tree_util.tree_map(jnp.asarray, m),
            v=jax.tree_util.tree_map(jnp.asarray, v)),
        jax.tree_util.tree_map(jnp.asarray, p), jnp.float32(lr))
    tg = tree_map(lambda t: t.to(getattr(torch, gdtype)), as_torch(g))
    g_before = tree_map(torch.clone, tg)
    tp = as_torch(p)
    ts = O.AdamWState(step=torch.tensor(step - 1, dtype=torch.int32),
                      m=as_torch(m), v=as_torch(v))
    ptrs = [t.data_ptr() for _, t in leaves(tp)]
    out_p, out_s = O.adamw_update(tg, ts, tp, lr=torch.tensor(lr))
    # in place: the same objects and storage, the gradients untouched
    assert out_p is tp and out_s is ts
    assert ptrs == [t.data_ptr() for _, t in leaves(tp)]
    for (_, a), (_, b) in zip(leaves(tg), leaves(g_before)):
        assert torch.equal(a, b)
    assert int(ts.step) == int(ref_s.step) == step
    for name, got, want in (("m", ts.m, ref_s.m), ("v", ts.v, ref_s.v)):
        for (path, a), (_, b) in zip(leaves(got), leaves(
                jax.tree_util.tree_map(np.asarray, want))):
            np.testing.assert_array_equal(to_np(a).view(np.int32),
                                          b.view(np.int32),
                                          err_msg=f"{name} {path}")
    for name, got, want in (("m", ts.m, ref_s.m), ("v", ts.v, ref_s.v),
                            ("params", tp, ref_p)):
        for (path, a), (_, b) in zip(leaves(got), leaves(
                jax.tree_util.tree_map(np.asarray, want))):
            np.testing.assert_array_equal(to_np(a).view(np.int32),
                                          b.view(np.int32),
                                          err_msg=f"{name} {path}")


def test_square_roots_are_correctly_rounded():
    """The reference's float32 sqrt under jit is correctly rounded, and
    so is ``_num.sqrt_f32``; torch's vectorized CPU ``sqrt`` is not."""
    from repro_torch._num import sqrt_f32
    x = (np.random.default_rng(0).random(1 << 16) * 1e-3).astype(np.float32)
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(jnp.sqrt)(x)), exact)
    np.testing.assert_array_equal(sqrt_f32(torch.from_numpy(x)).numpy(),
                                  exact)
    assert (torch.sqrt(torch.from_numpy(x)).numpy() != exact).any()


def test_bias_corrections_match():
    """``1 - b ** t`` for t = 1 .. 200,000, as the update computes it:
    bitwise, except one step for each b, two ulps apart at most."""
    t = np.arange(1, 200001, dtype=np.int32)
    for b, off in ((0.9, [31]), (0.95, [6])):
        ref = np.asarray(jax.jit(lambda s: 1.0 - b ** s.astype(
            jnp.float32))(jnp.asarray(t)))
        got = (1.0 - torch.pow(torch.full((), b, dtype=torch.float32),
                               torch.from_numpy(t).float())).numpy()
        diff = np.abs(ordered(got) - ordered(ref))
        assert (t[diff > 0] == off).all() and diff.max() <= 2, b


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches(max_norm, gdtype):
    g = grads_at(3)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, gdtype), g)
    ref_g, ref_n = jax.jit(lambda g: RO.clip_by_global_norm(g, max_norm))(jg)
    tg = tree_map(lambda t: t.to(getattr(torch, gdtype)), as_torch(g))
    ptr = tg["embed"].data_ptr()
    got_g, got_n = O.clip_by_global_norm(tg, max_norm)
    # in place: the given tree and leaves, scaled where they are
    assert got_g is tg and tg["embed"].data_ptr() == ptr
    assert abs(float(got_n) / float(ref_n) - 1) <= NORM_RTOL
    # bfloat16 leaves round back after the scale: an ulp of bf16 apart.
    # The reference writes zero for a denormal result, which the port
    # keeps; both read as zero in the update (adamw_update flushes).
    rtol = NORM_RTOL if gdtype == "float32" else 2.0 ** -7
    for (path, a), (_, b) in zip(leaves(got_g), leaves(ref_g)):
        assert a.dtype == getattr(torch, gdtype), path
        a = flush_denormals(a.float())
        b = np.asarray(b, np.float32)
        if max_norm >= float(ref_n):          # no clip: the same values
            np.testing.assert_array_equal(to_np(a), b, err_msg=str(path))
        assert (np.abs(to_np(a) - b) <= rtol * np.abs(b)).all(), path


@pytest.mark.parametrize("peak,warmup,total", [
    (3e-4, 100, 10000), (1e-3, 2, 20), (3e-4, 20, 300), (3e-4, 0, 10)])
def test_cosine_schedule_matches(peak, warmup, total):
    """Every step from 0 to past ``total``: the warmup, the decay, the
    floor."""
    steps = np.arange(0, total + 50, dtype=np.int32)
    ref = np.asarray(jax.jit(jax.vmap(lambda s: RO.cosine_schedule(
        s, peak_lr=peak, warmup=warmup, total=total)))(jnp.asarray(steps)))
    got = O.cosine_schedule(torch.from_numpy(steps), peak_lr=peak,
                            warmup=warmup, total=total)
    assert got.dtype == torch.float32
    assert (np.abs(ordered(got.numpy()) - ordered(ref)) <= ULPS).all()
    one = O.cosine_schedule(torch.tensor(total + 3, dtype=torch.int32),
                            peak_lr=peak, warmup=warmup, total=total)
    assert one.shape == () and one.dtype == torch.float32


def test_adamw_init_matches():
    p = as_torch(state_at(1, 0)[0])
    st = O.adamw_init(p)
    ref = RO.adamw_init(jax.tree_util.tree_map(jnp.asarray, state_at(1, 0)[0]))
    assert st.step.dtype == torch.int32 and int(st.step) == int(ref.step) == 0
    for tree in (st.m, st.v):
        for path, leaf in leaves(tree):
            assert leaf.dtype == torch.float32 and not leaf.any(), path
    assert st.m["embed"].data_ptr() != st.v["embed"].data_ptr()
    meta = O.adamw_init(tree_map(lambda t: t.to("meta"), p))
    assert meta.step.device.type == "meta" == meta.m["embed"].device.type
