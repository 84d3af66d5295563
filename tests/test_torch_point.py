"""Port parity of the point query's fused program (the ``point_probe``
kernel's plain version, ``kernels/point_probe.point_query_plain``).

On three indexes built by the JAX package and carried over to the port
(taxi points with duplicated points and long key runs on a kdtree whose
boxes share edges, with n_pad at the largest partition's count so that
windows clamp at n_pad - probe; gaussian points on R-tree leaves, whose
overflow grid holds data; a few points on many partitions, each holding
fewer than ``probe``), and on adversarial queries (data points and their
duplicates, misses one ulp away (a denormal one ulp from 0.0, which
XLA:CPU reads as 0.0), points on edges shared by two grid
boxes, points inside no grid box, the boxes' corners, whose keys fall
below the first knot and above the last), checked bitwise:

  * ``point_query_plain`` and the port engine's point query (torch
    backend) against the JAX engine's point query (``xla`` backend) and
    against the JAX package's own pieces (``queries.point_in_box``,
    ``queries.lower_bound_at`` jitted, ``kernels/ref.py`` ``point_probe``);
  * ``lower_bound_plain`` (and ``core/queries.lower_bound_at``) against
    the reference's ``lower_bound_at``, on the indexes and on synthetic
    knot rows built so that the fused and unfused interpolation round to
    different window starts, and so that positions fall half way;
  * a float32 step-by-step mirror of the CUDA kernel's arithmetic (the
    ballot's lowest box, an exact FMA, round half to even, the windows)
    against ``point_query_plain``.

The CUDA kernel itself is held against ``point_query_plain`` on the card
by ``tests/test_torch_gpu.py``.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SpatialEngine as JEngine
from repro.core import build_index as j_build, fit as j_fit
from repro.core import keys as JK
from repro.core import queries as JQ
from repro.kernels import ref
from repro_torch import convert
from repro_torch._num import fma_f32
from repro_torch.core import SpatialEngine
from repro_torch.core import build as TB
from repro_torch.core import queries as TQ
from repro_torch.kernels import point_probe as t_pp
from test_torch_gpu import POINT_CASES, point_args, point_points, point_queries

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

F32 = np.float32
j_lower_bound_at = jax.jit(JQ.lower_bound_at,
                           static_argnames=("radix_bits", "probe"))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=POINT_CASES)
def case(request):
    """The JAX engine and the port engine on the same index, and the
    adversarial queries with the JAX engine's answers."""
    x, y, part = point_points(request.param, j_fit)
    jidx = j_build(x, y, part)
    if request.param == "kdtree_dups":       # windows clamp at the end
        jidx = j_build(x, y, part, n_pad=int(np.max(jidx.count)) + 3)
    leaves = {n: np.asarray(getattr(jidx, n)) for n in TB.LEAVES}
    tidx = convert.index_from_arrays(
        leaves, device="cpu", eps=jidx.eps, radix_bits=jidx.radix_bits,
        probe=jidx.probe, overflow_pid=jidx.overflow_pid,
        key_spec=jidx.key_spec)
    jeng, eng = JEngine(jidx), SpatialEngine(tidx, device="cpu")
    assert jeng.backend == "xla"
    qx, qy = point_queries(x, y, np.asarray(eng.executor.bounds),
                           eng.executor.index.overflow)
    want = np.asarray(jeng.point_query(qx, qy))
    return request.param, x, y, jeng, eng, qx, qy, want


def _reference_pieces(jeng, qx, qy):
    """The JAX package's point program from its own pieces: the first
    grid box (point_in_box, argmax), lower_bound_at jitted, the window
    start, and kernels/ref.py's scan; (found, pid1, qk)."""
    ex = jeng.executor
    parts, bounds = ex.parts, ex.bounds
    ov, probe = ex.index.overflow, ex.index.probe
    n_pad = parts["keys_f"].shape[1]
    qk = JK.keys_to_f32(JK.make_keys(jnp.asarray(qx), jnp.asarray(qy),
                                     ex.index.key_spec))
    inb = np.asarray(JQ.point_in_box(jnp.asarray(qx), jnp.asarray(qy),
                                     bounds[:ov]))
    pid1 = np.where(inb.any(1), inb.argmax(1), ov).astype(np.int32)
    found = np.zeros(len(qx), bool)
    for pid in (pid1, np.full_like(pid1, ov)):
        pos = np.asarray(j_lower_bound_at(
            parts, jnp.asarray(pid), qk, radix_bits=ex.index.radix_bits,
            probe=probe))
        start = np.clip(pos - probe // 2, 0, n_pad - probe)
        lanes = start[:, None] + np.arange(probe)[None, :]
        win = [jnp.asarray(np.asarray(parts[n])[pid[:, None], lanes])
               for n in ("keys_f", "x", "y")]
        found |= np.asarray(ref.point_probe(qk, jnp.asarray(qx),
                                            jnp.asarray(qy), *win,
                                            probe=probe)) > 0
    return found, pid1, np.asarray(qk)


def test_point_query_plain_vs_jax(case):
    name, x, y, jeng, eng, qx, qy, want = case
    args, kw = point_args(eng.executor, qx, qy, "cpu")
    got = t_pp.point_query(*args, **kw)          # CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == (len(qx),)
    assert np.array_equal(got.numpy() > 0, want)
    assert torch.equal(t_pp.point_query_plain(*args, **kw), got)
    found, pid1, qk = _reference_pieces(jeng, qx, qy)
    assert np.array_equal(found, want)
    assert np.array_equal(eng.point_query(qx, qy).numpy(), want)
    daz = t_pp.flush_denormals                   # as XLA:CPU reads them
    pts = set(zip(daz(_t(x)).tolist(), daz(_t(y)).tolist()))
    assert want.tolist() == [(a, b) in pts for a, b in zip(
        daz(_t(qx)).tolist(), daz(_t(qy)).tolist())]
    # the adversarial cases are present
    ex = eng.executor
    ov, probe = ex.index.overflow, ex.index.probe
    bounds = np.asarray(ex.bounds)[:ov]
    inb = ((qx[:, None] >= bounds[:, 0]) & (qx[:, None] <= bounds[:, 2]) &
           (qy[:, None] >= bounds[:, 1]) & (qy[:, None] <= bounds[:, 3]))
    if name != "rtree_overflow":                 # kdtree boxes share edges
        assert (inb.sum(1) >= 2).any()
    assert (pid1 == ov).any()                    # inside no grid box
    assert want.any() and not want.all()
    kk = np.asarray(ex.parts["knot_keys"])
    assert (qk < kk[pid1, 0]).any()              # below the first knot
    last = kk[pid1, np.asarray(ex.parts["n_knots"])[pid1] - 1]
    assert (qk > last).any()                     # above the last knot
    count = np.asarray(ex.parts["count"])
    if name == "rtree_overflow":                 # found in the overflow
        assert (want & (pid1 == ov)).any()
    if name == "small_parts":
        assert (count[:ov + 1] < probe).all()


def test_point_query_windows_clamp(case):
    """Both window ends clamp: at 0, and at n_pad - probe where the
    index is packed (kdtree_dups)."""
    name, _, _, _, eng, qx, qy, _ = case
    args, kw = point_args(eng.executor, qx, qy, "cpu")
    bounds, kk, kp, keys_f, _, _, count, qxt, qyt, qk = args
    pid1 = t_pp.first_box(bounds, qxt, qyt, kw["overflow"])
    probe, n_pad = kw["probe"], keys_f.shape[1]
    pos = t_pp.lower_bound_plain(kk, kp, keys_f, count, pid1, qk,
                                 probe=probe)
    start = torch.clamp(pos - probe // 2, 0, n_pad - probe)
    assert bool((start == 0).any())
    if name == "kdtree_dups":
        assert bool((start == n_pad - probe).any())


def test_lower_bound_plain_vs_jax_on_index(case):
    _, _, _, jeng, eng, qx, qy, _ = case
    args, kw = point_args(eng.executor, qx, qy, "cpu")
    bounds, kk, kp, keys_f, _, _, count, qxt, qyt, qk = args
    ov, probe = kw["overflow"], kw["probe"]
    p_total = keys_f.shape[0]
    jex = jeng.executor
    for pid in (t_pp.first_box(bounds, qxt, qyt, ov),
                torch.full((len(qx),), ov, dtype=torch.int64),
                torch.arange(len(qx)) % p_total):
        got = t_pp.lower_bound_plain(kk, kp, keys_f, count, pid, qk,
                                     probe=probe)
        want = np.asarray(j_lower_bound_at(
            jex.parts, jnp.asarray(pid.numpy().astype(np.int32)),
            jnp.asarray(qk.numpy()), radix_bits=jex.index.radix_bits,
            probe=probe))
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(TQ.lower_bound_at(eng.executor.parts, pid, qk,
                                             probe=probe), got)


# -- the interpolation hazards -------------------------------------------

def _fma32(a, b, c):
    """Correctly rounded float32 a*b + c (ties to even), from the exact
    rational value: independent of the port's float64 emulation."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = F32(float(exact))
    cands = [np.nextafter(near, F32(-np.inf)), near,
             np.nextafter(near, F32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.asarray(v).view(np.int32)) & 1))


def _phat(q, k0, k1, p0, p1, fused: bool):
    with np.errstate(over="ignore"):             # -inf below a padded knot
        t = min(max(F32(F32(q - k0) / max(F32(k1 - k0), F32(1e-30))),
                    F32(0)), F32(1))
    if fused:
        return _fma32(t, F32(p1 - p0), p0)
    return F32(p0 + F32(t * F32(p1 - p0)))


@pytest.fixture(scope="module")
def synthetic():
    """Knot rows, position rows and key rows that do not agree with one
    another (so a window start off by one changes the lower bound), and
    query keys on which the fused and unfused interpolation round to
    different starts, keys at the knots (phat at a knot position, set
    half way between integers), below the first knot and above the
    last, in partitions with full, part full and short rows."""
    rng = np.random.default_rng(12)
    p_total, m, n_pad, probe = 4, 12, 1 << 16, 64
    kk = np.sort(rng.integers(0, 1 << 22, (p_total, m)), 1).astype(F32)
    kk[:, -3:] = F32(3.4e38)                     # the padded tail
    kp = np.sort(rng.uniform(0, n_pad, (p_total, m)), 1).astype(F32)
    kp[:, ::2] = np.floor(kp[:, ::2]) + F32(0.5)  # positions half way
    keys_f = np.sort(rng.integers(0, 1 << 22, (p_total, n_pad)),
                     1).astype(F32)
    count = np.asarray([n_pad, n_pad - 5, 700, 40], np.int32)
    # candidates, interpolated both ways at once; the fused form by the
    # port's emulation only picks them (the test checks the reference)
    cp = rng.integers(0, p_total, 1 << 20)
    cq = rng.integers(0, 1 << 22, 1 << 20).astype(F32)
    seg = np.clip((kk[cp] < cq[:, None]).sum(1) - 1, 0, m - 2)
    k0, k1 = kk[cp, seg], kk[cp, seg + 1]
    p0, p1 = kp[cp, seg], kp[cp, seg + 1]
    t = np.clip((cq - k0) / np.maximum(k1 - k0, F32(1e-30)), F32(0),
                F32(1)).astype(F32)
    fused = fma_f32(_t(t), _t(p1 - p0), _t(p0)).numpy()
    unfused = (p0 + (t * (p1 - p0)).astype(F32)).astype(F32)
    flips = np.flatnonzero(np.rint(fused) != np.rint(unfused))[:24]
    assert len(flips) >= 8                       # the hazard is real
    n_valid = m - 3
    pid, qk = [cp[flips]], [cq[flips]]
    for p in range(p_total):                     # knots, ends
        pid.append(np.full(n_valid + 3, p))
        qk.append(np.concatenate([kk[p, :n_valid], [
            F32(0), kk[p, n_valid - 1] + F32(64), F32(5e9)]]))
    pid = np.concatenate(pid).astype(np.int64)
    qk = np.concatenate(qk).astype(F32)
    return kk, kp, keys_f, count, pid, qk, probe, len(flips)


def test_lower_bound_plain_vs_jax_on_interpolation_hazards(synthetic):
    kk, kp, keys_f, count, pid, qk, probe, n_flips = synthetic
    got = t_pp.lower_bound_plain(_t(kk), _t(kp), _t(keys_f), _t(count),
                                 _t(pid), _t(qk), probe=probe).numpy()
    parts = {"knot_keys": jnp.asarray(kk), "knot_pos": jnp.asarray(kp),
             "keys_f": jnp.asarray(keys_f), "count": jnp.asarray(count)}
    want = np.asarray(j_lower_bound_at(parts, jnp.asarray(pid, jnp.int32),
                                       jnp.asarray(qk), radix_bits=10,
                                       probe=probe))
    assert np.array_equal(got, want)
    # the unfused interpolation would give other lower bounds
    unfused = []
    for p, q in zip(pid[:n_flips], qk[:n_flips]):
        row = kk[p]
        seg = min(max(int((row < q).sum()) - 1, 0), kk.shape[1] - 2)
        args = (q, row[seg], row[seg + 1], kp[p, seg], kp[p, seg + 1])
        ph = _phat(*args, False)
        assert np.rint(ph) != np.rint(_phat(*args, True))
        s = min(max(int(np.rint(ph)) - probe // 2, 0),
                keys_f.shape[1] - probe)
        unfused.append(min(s + int((keys_f[p, s:s + probe] < q).sum()),
                           int(count[p])))
    assert (np.asarray(unfused) != want[:n_flips]).any()


# -- the kernel's arithmetic, step by step ---------------------------------

def _kernel_mirror(bounds, kk, kp, keys_f, x, y, count, qx, qy, qk, *,
                   overflow, probe):
    """The CUDA kernel's steps in float32, one query at a time: a warp's
    32 lanes strided over the boxes and the lowest ballot bit, the
    segment over the whole knot row, an IEEE division, an exact FMA, round half to
    even, the two windows; coordinates compared with denormals as zero
    (as XLA:CPU reads them)."""
    def daz(v):
        return np.where(np.abs(v) < np.finfo(F32).tiny, F32(0), v)

    bounds, x, y, qx, qy = map(daz, (bounds, x, y, qx, qy))
    n_parts, n_pad = keys_f.shape
    m = kk.shape[1]
    half, last = probe // 2, n_pad - probe
    out = np.zeros(len(qk), np.int32)
    for q in range(len(qk)):
        vx, vy, k = qx[q], qy[q], qk[q]
        pid1 = overflow
        for b0 in range(0, overflow, 32):
            ballot = [g < overflow and bounds[g, 0] <= vx <= bounds[g, 2]
                      and bounds[g, 1] <= vy <= bounds[g, 3]
                      for g in range(b0, b0 + 32)]
            if any(ballot):
                pid1 = b0 + ballot.index(True)
                break
        for p in (pid1, overflow):
            p = min(max(p, 0), n_parts - 1)
            seg = min(max(int((kk[p] < k).sum()) - 1, 0), m - 2)
            phat = _phat(k, kk[p, seg], kk[p, seg + 1], kp[p, seg],
                         kp[p, seg + 1], True)
            start = min(max(int(np.rint(phat)) - half, 0), last)
            pos = min(start + int((keys_f[p, start:start + probe] < k).sum()),
                      int(count[p]))
            s2 = min(max(pos - half, 0), last)
            w = slice(s2, s2 + probe)
            hits = ((keys_f[p, w] == k) & (x[p, w] == vx) &
                    (y[p, w] == vy)).sum()
            out[q] |= int(hits > 0)
    return out


def test_kernel_mirror_equals_point_query_plain(case):
    _, _, _, _, eng, qx, qy, want = case
    args, kw = point_args(eng.executor, qx, qy, "cpu")
    plain = t_pp.point_query_plain(*args, **kw).numpy()
    got = _kernel_mirror(*(a.numpy() for a in args), **kw)
    assert np.array_equal(got, plain)
    assert np.array_equal(got > 0, want)
