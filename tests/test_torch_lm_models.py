"""The port's LM models against the JAX package, on the CPU.

Every arch at its smoke size runs the same batch (``make_batch(seed=1)``)
through both packages on the same weights: numpy draws on the JAX
package's parameter tree (``ref_weights``), carried into the port with
``convert.params_from_arrays``. At float32 compute (``dataclasses.replace``
on both sides) prefill logits, every cache leaf, one decode step's
logits and updated cache agree within ``F32_RTOL`` of the reference's
largest magnitude, and 8 greedy ``generate`` tokens are equal. In the
archs' own bf16 the logits agree within ``BF16_ATOL``, and greedy tokens
are equal at every step where the reference's top-2 margin exceeds it.

Then the modules where a port can go wrong: ``flash_attention`` with a
window, with ``kv_len`` and with several query chunks; ``gqa_decode``
past the cache's end (``dynamic_update_slice`` clamps); MLA's absorbed
decode against its expanded form; ``moe_ffn`` with capacity drops and
with tied gates (``lax.top_k`` takes the lowest index); the chunked
linear attention at chunks 16 and 64 with a state carried in; the SSD
branch and its decode. Last, the reference's own serving checks
(``tests/test_serve.py``, ``tests/test_mla.py``,
``tests/test_models_smoke.py``'s decode against forward) on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.data.tokens import make_batch as ref_batch
from repro.models import attention as RA
from repro.models import build_model as ref_build
from repro.models import hymba as RH
from repro.models import linear_attn as RL
from repro.models import moe as RM
from repro.models.common import ModelConfig as RefConfig
from repro.models.common import init_shapes as ref_init_shapes
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.tokens import make_batch
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import hymba as H
from repro_torch.models import linear_attn as LA
from repro_torch.models import moe as M
from repro_torch.models.common import ModelConfig
from repro_torch.serve import ServeSession, generate

torch.set_num_threads(1)
CPU = "cpu"
BATCH, PROMPT, STEPS = 2, 32, 8
# float32: relative to the reference's largest magnitude (measured at
# most 3.1e-6, hymba's SSM state; matmul summation orders differ)
F32_RTOL = 2e-5
# bf16: the reference's own bound for decode against forward
# (tests/test_models_smoke.py); measured at most 0.041, where dbrx routes
# one token to another expert
BF16_ATOL = 0.05


def to_np(tree):
    """Nested dict / tuple of jax arrays or tensors -> float64 numpy."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().double().numpy()
    return np.asarray(tree, np.float64)


def close_f32(got, want, what=""):
    got, want = to_np(got), to_np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            close_f32(got[k], want[k], f"{what}/{k}")
        return
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= F32_RTOL * max(np.abs(want).max(), 1e-30), (what, err)


def jitted(fn, *args, **kw):
    """The reference's ``fn(*args, **kw)`` under ``jax.jit`` (one compile,
    not one per op): arrays and dicts of them are traced, the rest
    (configs, chunk sizes, windows) static."""
    def traced(v):
        return isinstance(v, (dict, jax.Array, np.ndarray, np.generic))

    def call(ta, tk):
        it = iter(ta)
        return fn(*[next(it) if traced(a) else a for a in args],
                  **{**kw, **tk})
    return jax.jit(call)([a for a in args if traced(a)],
                         {k: v for k, v in kw.items() if traced(v)})


def t(a, dtype=None):
    """A numpy / jax array as a CPU tensor (bf16 bits kept)."""
    out = convert.params_from_arrays(np.asarray(a), device=CPU)
    return out if dtype is None else out.to(dtype)


def ref_weights(cfg, seed: int = 0):
    """Weights on the reference's parameter tree (``init_shapes``) by
    ``init_params``' rule (std 0.02; 1-D leaves zero), drawn with numpy:
    the same values as JAX arrays and as the port's tensors. (The
    reference's own ``init`` compiles a sampler per leaf shape, about
    30 s for the ten archs; ``test_torch_lm_configs.py`` carries its
    output across.)"""
    rng = np.random.default_rng(seed)
    is_shape = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(i, int) for i in x)

    def one(shape):
        if len(shape) == 1 or shape[-1] == 1:
            return np.zeros(shape, np.float32)
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    arrays = jax.tree_util.tree_map(one, ref_init_shapes(cfg),
                                    is_leaf=is_shape)
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            convert.params_from_arrays(arrays, device=CPU))


@pytest.fixture(scope="module")
def weights():
    """{arch: (reference params, the port's copy)}, each made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = ref_weights(ref_config(arch, smoke=True))
        return cache[arch]
    return get


def _models(arch, dtype):
    rc = ref_config(arch, smoke=True)
    pc = get_config(arch, smoke=True)
    if dtype is not None:
        rc = dataclasses.replace(rc, compute_dtype=dtype)
        pc = dataclasses.replace(pc, compute_dtype=dtype)
    return rc, ref_build(rc), build_model(pc)


def _prompt(rc):
    b = ref_batch(rc, BATCH, PROMPT, seed=1)
    return {k: v for k, v in b.items() if k not in ("labels", "mask")}


def _margin(logits):
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return (top[..., -1] - top[..., -2]).min()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_serves_as_the_reference(weights, arch, dtype):
    rc, rm, pm = _models(arch, dtype)
    rp, pp = weights(arch)
    rb = _prompt(rc)
    pb = {k: t(v) for k, v in rb.items()}
    prompt_len = rb["tokens"].shape[1] + (rc.n_patches if rc.patch_input
                                          else 0)
    max_len = prompt_len + STEPS        # as generate sizes the cache
    r_pre = jax.jit(lambda p, b: rm.prefill(p, b, max_len=max_len))
    r_dec = jax.jit(rm.decode_step)
    rl, rcache = r_pre(rp, rb)
    pl, pcache = pm.prefill(pp, pb, max_len=max_len)
    assert pl.dtype == pm.cfg.cdtype and pl.shape == rl.shape

    # the reference's generate, step by step (its logits kept)
    r_logits, r_toks = [rl], []
    tok = jnp.argmax(rl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    r_caches = []
    for i in range(STEPS):
        r_toks.append(np.asarray(tok))
        rl_i, rcache_i = r_dec(rp, rcache if i == 0 else r_caches[-1], tok,
                               jnp.int32(prompt_len + i))
        r_caches.append(rcache_i)
        r_logits.append(rl_i)
        tok = jnp.argmax(rl_i[:, -1], axis=-1)[:, None].astype(jnp.int32)
    r_toks = np.concatenate(r_toks, axis=1)

    first = torch.from_numpy(r_toks[:, :1].copy())
    pl1, pcache1 = pm.decode_step(pp, pcache, first, prompt_len)
    got = generate(pm, pp, pb, steps=STEPS, device=CPU)
    assert got.shape == (BATCH, STEPS) and got.dtype == torch.int32
    got = got.numpy()

    if dtype == "float32":
        close_f32(pl, rl, "prefill logits")
        close_f32(pcache, rcache, "prefill cache")
        close_f32(pl1, r_logits[1], "decode logits")
        close_f32(pcache1, r_caches[0], "decode cache")
        np.testing.assert_array_equal(got, r_toks)
        return
    for got_l, want_l in ((pl, rl), (pl1, r_logits[1])):
        err = np.abs(to_np(got_l) - to_np(want_l)).max()
        assert err < BF16_ATOL, err
    for i in range(STEPS):
        if not np.array_equal(got[:, i], r_toks[:, i]):
            # a near tie: the reference's pick is not clear of bf16 noise
            assert _margin(r_logits[i][:, -1]) <= BF16_ATOL, i
            break


# -- attention ----------------------------------------------------------------

def _qkv(rng, b, tq, tk, h, kv, d):
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(b, tq, h, d), mk(b, tk, kv, d), mk(b, tk, kv, d)


@pytest.mark.parametrize("case", ["window", "kv_len", "cross", "sharp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches(case, dtype):
    """``sharp``: scores of about +-16, where a bf16 score is 0.125 apart
    from the next: the reference's products are float32
    (``preferred_element_type``), so a port whose einsum rounds them to
    bf16 weighs the keys visibly otherwise."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 32, 32, 4, 2, 16)
    if case == "sharp":
        q, k = q * 4, k * 4
    jt = jnp.dtype(dtype)
    tt = getattr(torch, dtype)
    pos = np.arange(32, dtype=np.int32)
    kw = dict(q_pos=pos, k_pos=pos, q_chunk=16, kv_chunk=8)
    if case == "window":
        kw["window"] = 5
    elif case == "kv_len":
        kw.update(kv_len=np.int32(21), causal=False)
    elif case == "cross":       # decoder queries over a memory
        kw.update(q_pos=np.full(32, 32, np.int32), kv_len=np.int32(27))
    arrays = (np.ndarray, np.integer)
    # at q_chunk == Tq: the reference interleaves rows of several query
    # chunks (ROADMAP §3), so compare where it has one
    want = jitted(RA.flash_attention, *[jnp.asarray(a, jt) for a in (q, k, v)],
                  **{a: jnp.asarray(b) if isinstance(b, arrays) else b
                     for a, b in dict(kw, q_chunk=32).items()})
    tkw = {a: torch.from_numpy(np.asarray(b)) if isinstance(b, arrays)
           else b for a, b in kw.items()}
    got = A.flash_attention(t(q, tt), t(k, tt), t(v, tt), **tkw)
    got_one = A.flash_attention(t(q, tt), t(k, tt), t(v, tt),
                                **dict(tkw, q_chunk=32))
    assert got.dtype == tt
    if dtype == "float32":
        close_f32(got, want)
        close_f32(got_one, want)
    else:
        # bf16 outputs of float32 arithmetic: one rounding apart
        for g in (got, got_one):
            err = np.abs(to_np(g) - to_np(want)).max()
            assert err <= 2 ** -7 * np.abs(to_np(want)).max(), err


def test_reference_interleaves_query_chunks():
    """The reference's flash_attention at Tq > q_chunk returns its rows
    in the order (row within chunk, chunk) — a fault of the reference
    (ROADMAP §3). The port returns them in order: the same as one chunk."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, 8, 8, 2, 2, 4)
    pos = np.arange(8, dtype=np.int32)
    qkv = [jnp.asarray(a) for a in (q, k, v)]
    one = jitted(RA.flash_attention, *qkv, q_pos=jnp.asarray(pos),
                 k_pos=jnp.asarray(pos), q_chunk=8, kv_chunk=8)
    two = jitted(RA.flash_attention, *qkv, q_pos=jnp.asarray(pos),
                 k_pos=jnp.asarray(pos), q_chunk=4, kv_chunk=8)
    tp = torch.from_numpy(pos)
    got = A.flash_attention(t(q), t(k), t(v), q_pos=tp, k_pos=tp,
                            q_chunk=4, kv_chunk=8)
    close_f32(got, one)
    interleaved = np.asarray(one)[:, [0, 4, 1, 5, 2, 6, 3, 7]]
    np.testing.assert_allclose(np.asarray(two), interleaved, rtol=1e-6,
                               atol=1e-7)


def _gqa_layer(arch="qwen2_5_3b"):
    rc = dataclasses.replace(ref_config(arch, smoke=True),
                             compute_dtype="float32")
    pc = dataclasses.replace(get_config(arch, smoke=True),
                             compute_dtype="float32")
    rp = ref_weights(rc, 1)[0]
    lp = jax.tree_util.tree_map(lambda a: a[0], rp["layers"])["attn"]
    return rc, pc, lp, convert.params_from_arrays(
        jax.tree_util.tree_map(np.asarray, lp), device=CPU)


@pytest.mark.parametrize("pos", [5, 15, 16, 19])
def test_gqa_decode_clamps_past_the_cache(pos):
    """``dynamic_update_slice`` clamps its start so the update fits: at
    pos >= max_len the reference writes the last slot, and so must the
    port (an unclamped write raises or lands elsewhere)."""
    rc, pc, rlp, plp = _gqa_layer()
    rng = np.random.default_rng(pos)
    s_max = 16
    x = rng.standard_normal((2, 1, rc.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, s_max, rc.n_kv_heads,
                              rc.head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    want, (wk, wv) = jitted(RA.gqa_decode, rlp, jnp.asarray(x), rc,
                            cache_k=jnp.asarray(ck),
                            cache_v=jnp.asarray(cv),
                            pos=jnp.int32(pos), window=6)
    got, (gk, gv) = A.gqa_decode(plp, t(x), pc, cache_k=t(ck),
                                 cache_v=t(cv), pos=pos, window=6)
    close_f32(got, want)
    close_f32(gk, wk)
    close_f32(gv, wv)
    slot = min(pos, s_max - 1)
    assert not np.allclose(to_np(gk)[:, slot], ck[:, slot])


def test_gqa_decode_scores_in_float32():
    """bf16 compute against a sharp bf16 cache (scores of about +-30):
    the reference's score and context products are float32
    (``preferred_element_type``); rounding them to bf16 moves the
    output by many bf16 ulps."""
    rc, pc, rlp, plp = _gqa_layer()
    rc = dataclasses.replace(rc, compute_dtype="bfloat16")
    pc = dataclasses.replace(pc, compute_dtype="bfloat16")
    rng = np.random.default_rng(7)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    x = bf(rng.standard_normal((2, 1, rc.d_model)))
    ck = bf(rng.standard_normal((2, 16, rc.n_kv_heads, rc.head_dim)) * 300)
    cv = bf(rng.standard_normal(ck.shape))
    want, _ = jitted(RA.gqa_decode, rlp, jnp.asarray(x), rc,
                     cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
                     pos=jnp.int32(9))
    got, _ = A.gqa_decode(plp, t(x), pc, cache_k=t(ck), cache_v=t(cv),
                          pos=9)
    assert got.dtype == torch.bfloat16
    err = np.abs(to_np(got) - to_np(want)).max()
    assert err <= 2 ** -7 * np.abs(to_np(want)).max(), err


def _mla_cfgs(**kw):
    args = dict(name="mla-test", vocab=64, d_model=32, n_layers=1,
                n_heads=4, n_kv_heads=4, attn="mla", q_lora=0, kv_lora=16,
                qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8, d_ff=64,
                compute_dtype="float32")
    args.update(kw)
    return RefConfig(**args), ModelConfig(**args)


@pytest.mark.parametrize("q_lora", [0, 12])
def test_mla_absorbed_decode_matches(q_lora):
    """The reference's test_mla.py on both packages: the absorbed decode
    of the last token equals the expanded form's last row, and each
    function equals the reference's."""
    rc, pc = _mla_cfgs(q_lora=q_lora)
    rp = ref_weights(rc, 0)[0]
    rlp = jax.tree_util.tree_map(lambda a: a[0], rp["layers"])["attn"]
    plp = convert.params_from_arrays(
        jax.tree_util.tree_map(np.asarray, rlp), device=CPU)
    rng = np.random.default_rng(0)
    n = 9
    x = rng.standard_normal((2, n, 32)).astype(np.float32)
    pos = np.arange(n, dtype=np.int32)
    want, (wc, wr) = jitted(RA.mla_attn, rlp, jnp.asarray(x), rc,
                                 positions=jnp.asarray(pos))
    got, (gc, gr) = A.mla_attn(plp, t(x), pc, positions=torch.from_numpy(pos))
    close_f32(got, want)
    close_f32(gc, wc)
    close_f32(gr, wr)
    cache_c = np.zeros((2, n, rc.kv_lora), np.float32)
    cache_c[:, :n - 1] = np.asarray(wc)[:, :n - 1]
    cache_r = np.zeros((2, n, rc.qk_rope_dim), np.float32)
    cache_r[:, :n - 1] = np.asarray(wr)[:, :n - 1]
    rd, _ = jitted(RA.mla_decode, rlp, jnp.asarray(x[:, n - 1:]), rc,
                          cache_c=jnp.asarray(cache_c),
                          cache_rope=jnp.asarray(cache_r),
                          pos=jnp.int32(n - 1))
    pd, (pcc, pcr) = A.mla_decode(plp, t(x[:, n - 1:]), pc,
                                  cache_c=t(cache_c), cache_rope=t(cache_r),
                                  pos=n - 1)
    close_f32(pd, rd)
    assert np.abs(to_np(pd)[:, 0] - to_np(got)[:, -1]).max() < 1e-4
    close_f32(pcc, wc)
    close_f32(pcr, wr)


# -- MoE ----------------------------------------------------------------------

def _moe_params(rng, d, e, f, shared=0, tied=False):
    mk = lambda *s: (rng.standard_normal(s) * 0.1  # noqa: E731
                     ).astype(np.float32)
    p = {"router": mk(d, e) * (0 if tied else 1), "we1": mk(e, d, f),
         "we3": mk(e, d, f), "we2": mk(e, f, d)}
    if shared:
        p.update(ws1=mk(d, f * shared), ws3=mk(d, f * shared),
                 ws2=mk(f * shared, d))
    return p


@pytest.mark.parametrize("case", ["drops", "ties", "shared", "bf16"])
def test_moe_ffn_matches(case):
    """Capacity drops (factor 0.1: most dispatches dropped), tied gates
    (a zero router: every gate 1/E, so ``lax.top_k`` picks experts 0..k-1
    for every token, which ``torch.topk`` would not keep), shared
    experts, and bf16 compute."""
    kw = dict(d_model=8, n_experts=4, top_k=2, d_expert=16, moe=True)
    if case == "drops":
        kw.update(top_k=1, capacity_factor=0.1)
    if case == "shared":
        kw.update(n_shared=1, capacity_factor=0.5)
    if case == "bf16":
        kw["compute_dtype"] = "bfloat16"
    rc, pc = RefConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(11)
    p = _moe_params(rng, 8, 4, 16, shared=kw.get("n_shared", 0),
                    tied=case == "ties")
    x = rng.standard_normal((2, 24, 8)).astype(np.float32)
    dt = jnp.bfloat16 if case == "bf16" else jnp.float32
    want, waux = jitted(RM.moe_ffn, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x, dt), rc)
    got, gaux = M.moe_ffn(convert.params_from_arrays(p, device=CPU),
                          t(np.asarray(jnp.asarray(x, dt))), pc)
    assert got.dtype == (torch.bfloat16 if case == "bf16" else torch.float32)
    if case == "bf16":
        assert np.abs(to_np(got) - to_np(want)).max() < 2 ** -6
        # the router's logits round to bf16 before the softmax
        assert abs(float(gaux) - float(waux)) < 2 ** -8 * float(waux)
        return
    close_f32(got, want)
    close_f32(gaux, waux)
    if case == "drops":
        # capacity 8 per expert for 48 tokens: at least 16 dropped
        norms = np.linalg.norm(to_np(got).reshape(-1, 8), axis=-1)
        assert (norms < 1e-6).sum() >= 16


def test_top_k_takes_the_lowest_index_on_ties():
    gates = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = M.top_k_lowest_index(gates, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(gates.numpy()), 3)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2, 4]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


# -- linear attention and SSD ------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_linear_attn_threads_state(chunk):
    rng = np.random.default_rng(chunk)
    b, n, h, dk, dv = 2, 128, 2, 8, 8
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = mk(b, n, h, dk), mk(b, n, h, dk), mk(b, n, h, dv)
    logw = (-0.3 * np.exp(mk(b, n, h, dk) * 0.3)).astype(np.float32)
    logw[:, 5::64] = -100.0     # below the clip, once in every 64
    bonus = mk(h, dk)
    s0 = mk(b, h, dk, dv)
    want, wst = jitted(RL.chunked_linear_attn,
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(logw),
        chunk=chunk, state=jnp.asarray(s0), bonus=jnp.asarray(bonus))
    got, gst = LA.chunked_linear_attn(t(q), t(k), t(v), t(logw),
                                      chunk=chunk, state=t(s0),
                                      bonus=t(bonus))
    close_f32(got, want)
    close_f32(gst, wst)
    # the second half from the first half's state
    _, st1 = LA.chunked_linear_attn(t(q[:, :64]), t(k[:, :64]),
                                    t(v[:, :64]), t(logw[:, :64]),
                                    chunk=chunk, state=t(s0),
                                    bonus=t(bonus))
    h2, st2 = LA.chunked_linear_attn(t(q[:, 64:]), t(k[:, 64:]),
                                     t(v[:, 64:]), t(logw[:, 64:]),
                                     chunk=chunk, state=st1, bonus=t(bonus))
    close_f32(h2, np.asarray(want)[:, 64:])
    close_f32(st2, wst)
    rd, rs = jitted(RL.linear_attn_decode,
        jnp.asarray(q[:, 0]), jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]),
        jnp.asarray(logw[:, 0]), jnp.asarray(s0), bonus=jnp.asarray(bonus))
    gd, gs = LA.linear_attn_decode(t(q[:, 0]), t(k[:, 0]), t(v[:, 0]),
                                   t(logw[:, 0]), t(s0), bonus=t(bonus))
    close_f32(gd, rd)
    close_f32(gs, rs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_branch_and_decode_match(dtype):
    rc = dataclasses.replace(ref_config("hymba_1_5b", smoke=True),
                             compute_dtype=dtype)
    pc = dataclasses.replace(get_config("hymba_1_5b", smoke=True),
                             compute_dtype=dtype)
    rp = ref_weights(rc, 2)[0]
    rlp = jax.tree_util.tree_map(lambda a: a[0], rp["layers"])["ssm"]
    rng = np.random.default_rng(5)
    # a non-zero a_log and norm, so every term of the branch shows
    rlp = dict(rlp, a_log=jnp.asarray(rng.standard_normal(
        rlp["a_log"].shape).astype(np.float32)))
    plp = convert.params_from_arrays(
        jax.tree_util.tree_map(np.asarray, rlp), device=CPU)
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 32, rc.d_model)),
                               jt))
    s0 = rng.standard_normal((2, rc.ssm_heads, rc.ssm_state,
                              rc.ssm_head_dim)).astype(np.float32)
    want, wst = jitted(RH.ssd_branch, rlp, jnp.asarray(x), rc,
                       state=jnp.asarray(s0))
    got, gst = H.ssd_branch(plp, t(x), pc, state=t(s0))
    wd, wds = jitted(RH.ssd_decode, rlp, jnp.asarray(x[:, :1]), rc,
                     jnp.asarray(s0))
    gd, gds = H.ssd_decode(plp, t(x[:, :1]), pc, t(s0))
    assert got.dtype == gd.dtype == tt
    if dtype == "float32":
        for g, w in ((got, want), (gst, wst), (gd, wd), (gds, wds)):
            close_f32(g, w)
        return
    for g, w in ((got, want), (gd, wd)):
        err = np.abs(to_np(g) - to_np(w)).max()
        assert err <= 2 ** -6 * np.abs(to_np(w)).max(), err


# -- the reference's own serving checks, on the port -------------------------

@pytest.fixture(scope="module")
def qwen(weights):
    cfg = get_config("qwen2.5-3b", smoke=True)
    return cfg, build_model(cfg), weights("qwen2_5_3b")[1]


def test_greedy_generate_deterministic(qwen):
    cfg, model, params = qwen
    b = {"tokens": make_batch(cfg, 2, 16, seed=1, device=CPU)["tokens"]}
    out1 = generate(model, params, b, steps=8, device=CPU)
    out2 = generate(model, params, b, steps=8, device=CPU)
    assert out1.shape == (2, 8)
    assert torch.equal(out1, out2)


def test_generate_matches_stepwise_forward(qwen):
    """Greedy decode must equal greedy argmax over repeated fwd passes."""
    cfg, model, params = qwen
    toks = make_batch(cfg, 1, 8, seed=2, device=CPU)["tokens"]
    out = generate(model, params, {"tokens": toks}, steps=4, device=CPU)
    cur = toks
    for i in range(4):
        logits = model.forward(params, {"tokens": cur})[0]
        nxt = int(torch.argmax(logits[0, -1]))
        assert nxt == int(out[0, i]), f"token {i}"
        cur = torch.cat([cur, torch.tensor([[nxt]], dtype=cur.dtype)], 1)


def test_serve_session_steps(qwen):
    cfg, model, params = qwen
    sess = ServeSession(model, params, batch_size=4, max_len=32, device=CPU)
    tok = torch.zeros((4, 1), dtype=torch.int32)
    for _ in range(3):
        logits = sess.step(tok)
        assert logits.shape == (4, 1, cfg.vocab)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    assert int(sess.pos[0]) == 3


def test_rwkv_session_state_based(weights):
    cfg = get_config("rwkv6-3b", smoke=True)
    model = build_model(cfg)
    params = weights("rwkv6_3b")[1]
    sess = ServeSession(model, params, batch_size=2, max_len=8, device=CPU)
    logits = sess.step(torch.ones((2, 1), dtype=torch.int32))
    assert logits.shape == (2, 1, cfg.vocab)


def test_mla_cache_is_compressed():
    cfg = ModelConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                      attn="mla", kv_lora=512, qk_rope_dim=64)
    assert (cfg.kv_lora + cfg.qk_rope_dim) * 7 < \
        2 * cfg.n_kv_heads * cfg.head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(weights, arch):
    """tests/test_models_smoke.py's check on the port, in the archs' own
    bf16: decoding the last token from a cache of the others gives the
    full forward's last logits within the reference's 0.05."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = weights(arch)[1]
    batch = make_batch(cfg, 2, 32, seed=1, device=CPU)
    tok = batch["tokens"]
    b1 = dict(batch, tokens=tok[:, :-1])
    if cfg.family == "encdec":
        full, _, _ = model.forward(params, batch)
        _, cache = model.prefill(params, b1, max_len=tok.shape[1])
        dec, _ = model.decode_step(params, cache, tok[:, -1:],
                                   tok.shape[1] - 1)
    elif cfg.family == "rwkv6":
        full, _ = model._forward(params, tok,
                                 model.init_state(2, device=CPU))
        _, cache = model.prefill(params, b1)
        dec, _ = model.decode_step(params, cache, tok[:, -1:], None)
    else:
        off = cfg.n_patches if cfg.patch_input else 0
        full = model.forward(params, batch)[0]
        _, cache = model.prefill(params, b1, max_len=off + tok.shape[1])
        dec, _ = model.decode_step(params, cache, tok[:, -1:],
                                   off + tok.shape[1] - 1)
    diff = float((dec[:, 0].float() - full[:, -1].float()).abs().max())
    assert diff < 0.05, f"{arch}: decode diverges from forward ({diff})"
