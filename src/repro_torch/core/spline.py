"""Error-bounded greedy spline (paper §3.2, RadixSpline / Neumann-Michel).

Given keys sorted ascending, fit a piecewise-linear spline S with
``|S(key_i) - pos_i| <= eps`` at the FIRST occurrence position of every
distinct key, in ONE sequential pass. Like RadixSpline the CDF is fit
over distinct keys; ``max_run`` (the longest run of equal keys) sizes
the probe window that keeps every lookup exact.

The reference runs the pass as a scalar-carry ``lax.scan`` per partition
under ``vmap``. Here the same recurrence is a float32 loop over
positions in numpy on the host, vectorized across partitions: the
carries are (P,) arrays and every step is the reference's float32
arithmetic in the same order (no multiply-add occurs, so nothing is
contracted), so the knots match bit for bit. The host keeps the
sequential loop at one numpy call per operation per POSITION, for all
partitions together — a few seconds at 2^23 points in ~130 partitions,
where a loop on the card would pay one launch per operation per
position.
"""
from __future__ import annotations

import numpy as np

NEG = np.float32(-3.4e38)
POS = np.float32(3.4e38)


def build_spline(keys_f32: np.ndarray, valid: np.ndarray, *, eps: int,
                 m_pad: int) -> dict:
    """Fit the greedy corridor spline of every partition.

    Args:
      keys_f32: (P, N) float32 keys, each row sorted ascending; padding
        entries at the end of a row, marked invalid.
      valid:    (P, N) bool.
      eps:      position error bound (paper default 32).
      m_pad:    knot capacity per partition.

    Returns dict of numpy arrays:
      knot_keys (P, m_pad) f32 padded with POS, knot_pos (P, m_pad) f32,
      n_knots (P,) int32, max_run (P,) int32, overflow (P,) bool.
    """
    keys = np.ascontiguousarray(keys_f32, np.float32)
    p_total, n = keys.shape
    prev = np.concatenate([np.full((p_total, 1), -1.0, np.float32),
                           keys[:, :-1]], axis=1)
    first_occ = valid & (keys != prev)
    epsf = np.float32(eps)

    kk = np.zeros(p_total, np.float32)
    kp = np.zeros(p_total, np.float32)
    lo = np.full(p_total, NEG, np.float32)
    hi = np.full(p_total, POS, np.float32)
    px = np.zeros(p_total, np.float32)
    pp = np.zeros(p_total, np.float32)
    started = np.zeros(p_total, bool)
    emit_f = np.zeros((p_total, n), bool)
    emit_k = np.zeros((p_total, n), np.float32)
    emit_p = np.zeros((p_total, n), np.float32)

    # positions at or past every row's last valid entry change nothing
    last = int(np.max(np.nonzero(valid.any(0))[0], initial=-1)) + 1
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for i in range(last):
            x = keys[:, i]
            y = np.float32(i)
            use = first_occ[:, i]
            # corridor slopes vs the current knot (garbage when not
            # started or dx == 0; masked out by the selects below)
            dx = x - kk
            s_lo = (y - epsf - kp) / dx
            s_hi = (y + epsf - kp) / dx
            inside = (s_lo <= hi) & (s_hi >= lo)
            is_first = use & ~started
            new_knot = use & started & ~inside
            tighten = use & started & inside
            # corridor restarted from the previous point (new_knot case)
            dx2 = x - px
            lo2 = (y - epsf - pp) / dx2
            hi2 = (y + epsf - pp) / dx2
            emit = is_first | new_knot
            emit_f[:, i] = emit
            emit_k[:, i] = np.where(is_first, x, px)
            emit_p[:, i] = np.where(is_first, y, pp)
            kk = np.where(is_first, x, np.where(new_knot, px, kk))
            kp = np.where(is_first, y, np.where(new_knot, pp, kp))
            lo = np.where(is_first, NEG,
                          np.where(new_knot, lo2,
                                   np.where(tighten, np.maximum(lo, s_lo),
                                            lo)))
            hi = np.where(is_first, POS,
                          np.where(new_knot, hi2,
                                   np.where(tighten, np.minimum(hi, s_hi),
                                            hi)))
            px = np.where(use, x, px)
            pp = np.where(use, y, pp)
            started = started | use

    # compact the emitted stream into the knot arrays (order-preserving;
    # slots past m_pad clamp to the last one, as the reference's scatter
    # does — they only occur when overflow is flagged)
    cnt = emit_f.sum(1).astype(np.int32)
    knots_k = np.full((p_total, m_pad), POS, np.float32)
    knots_p = np.zeros((p_total, m_pad), np.float32)
    rows, cols = np.nonzero(emit_f)
    slot = np.minimum(np.cumsum(emit_f, axis=1)[rows, cols] - 1, m_pad - 1)
    knots_k[rows, slot] = emit_k[rows, cols]
    knots_p[rows, slot] = emit_p[rows, cols]

    def emit_tail(mask, k, p):
        at = np.minimum(cnt, m_pad - 1)
        r = np.nonzero(mask)[0]
        knots_k[r, at[r]] = k[r]
        knots_p[r, at[r]] = p[r]
        return cnt + mask.astype(np.int32)

    # close the spline: the last seen point becomes the final knot
    # (unless it already is the only knot)
    cnt = emit_tail(started & ((cnt == 1) | (px != kk)), px, pp)
    # single distinct key: a synthetic second knot keeps interpolation
    # away from a zero-width segment
    cnt = emit_tail(started & (cnt == 1), kk + np.float32(1.0), kp)

    # longest run of equal keys among valid entries
    run_id = np.cumsum(first_occ, axis=1) - 1
    run_id = np.where(valid, run_id, n)
    flat = (np.arange(p_total)[:, None] * (n + 1) + run_id).ravel()
    run_len = np.bincount(flat, weights=valid.ravel().astype(np.float64),
                          minlength=p_total * (n + 1))
    max_run = run_len.reshape(p_total, n + 1)[:, :n].max(1).astype(np.int32)

    return {
        "knot_keys": knots_k,
        "knot_pos": knots_p,
        "n_knots": np.minimum(cnt, m_pad).astype(np.int32),
        "max_run": max_run,
        "overflow": cnt > m_pad,
    }
