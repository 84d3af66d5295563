"""Point probe — window equality scan after the learned lookup: CUDA
kernel, plain version, wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/point_probe.py``
(``point_probe``; wrapper ``kernels/ops.py:point_probe``). Source:
``csrc/point_probe.cu``. The kernel fuses the window gather the
reference does on the host (``XlaBackend.point_windows``): it reads
keys_f, x and y at (pid, start) itself. Bound: bytes (12 per window slot).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._args import I, P, on_cpu, ptr, stream

launches = 0        # kernel launches (not plain-version calls)

_SIG = {"point_probe_launch": [P, P, P, P, P, P, P, P, I, I, I, I, P, P]}


def gather_windows(pid, start, probe: int, *planes):
    """Each query's (probe,) window of each (P, n_pad) plane, read from
    its partition ``pid`` at ``start``: tuple of (Q, probe) tensors."""
    cols = start[:, None].to(torch.int64) + torch.arange(
        probe, device=start.device)
    rows = pid[:, None].to(torch.int64)
    return tuple(p[rows, cols] for p in planes)


def count_matches(qk, qx, qy, wk, wx, wy):
    """(Q,) int32 count of window slots equal to the query in key, x, y."""
    m = (wk == qk[:, None]) & (wx == qx[:, None]) & (wy == qy[:, None])
    return m.sum(1, dtype=torch.int32)


def point_probe_plain(pid, start, qk, qx, qy, keys_f, x, y, *, probe: int):
    """The kernel's function: gather each window, count the matches."""
    return count_matches(qk, qx, qy,
                         *gather_windows(pid, start, probe, keys_f, x, y))


def point_probe(pid, start, qk, qx, qy, keys_f, x, y, *, probe: int):
    """Exact-match counts in each query's probe window (found iff > 0).

    pid, start (Q,) int32 — partition and window start per query, with
    0 <= start <= n_pad - probe; qk, qx, qy (Q,) f32; keys_f, x, y
    (P, n_pad) f32. CPU tensors run the plain version; CUDA tensors
    launch the kernel.
    """
    args = (pid, start, qk, qx, qy, keys_f, x, y)
    if on_cpu(*args):
        return point_probe_plain(*args, probe=probe)
    p_total, n_pad = keys_f.shape
    nq = qk.shape[0]
    if not 0 < probe <= n_pad:
        raise ValueError(f"probe {probe} outside (0, n_pad={n_pad}]")
    f32, i32 = torch.float32, torch.int32
    ptrs = [ptr(pid, "pid", i32, (nq,)), ptr(start, "start", i32, (nq,)),
            ptr(qk, "qk", f32, (nq,)), ptr(qx, "qx", f32, (nq,)),
            ptr(qy, "qy", f32, (nq,)),
            ptr(keys_f, "keys_f", f32, (p_total, n_pad)),
            ptr(x, "x", f32, (p_total, n_pad)),
            ptr(y, "y", f32, (p_total, n_pad))]
    out = torch.empty((nq,), dtype=i32, device=qk.device)
    if nq == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load("point_probe", _SIG)
    err = lib.point_probe_launch(*ptrs, nq, p_total, n_pad, probe,
                                 ptr(out, "out", i32, (nq,)), stream())
    _build.check(lib, "point_probe", err)
    global launches
    launches += 1
    return out
