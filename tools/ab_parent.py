#!/usr/bin/env python3
"""Time this tree's port against another tree's (a parent commit's) in
one process on one CUDA card: the four kernels that read float32
denormals as zero (range_count, circle_count, knn_topk and the join's
point_in_polygon) at their main-path shapes, and a steady serving round
at q = 16.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 tools/ab_parent.py build/parent

The other tree's whole package is imported from its files beside this
tree's: its modules are held apart from this tree's, and each turn puts
one tree's modules in ``sys.modules``, so every import inside a call
(the kernel wrappers import ``_build`` when they first launch) resolves
to that tree. Each tree builds its own kernels from its own sources into
its own ``build/`` directory. The index (chip_smoke.py's: taxi, 2^23
points, kdtree with 128 partitions) is built once, by this tree, and
served by both; each tree has its own serving session, warmed on the
same round. A serving batch of q = 64 is this tree's alone (the parent
raises there), so it has no A/B here; chip_smoke.py measures it.

  - in turns (parent, change, change, parent): each kernel's device time
    per main-path call (its launches over every partition chunk of the
    1,024-rect range count, the 256-circle exact circle program, the
    256-query exact 10-NN and the 32-polygon full join; CUDA events with
    the stream held busy: chip_smoke.stream_ms), and the steady round's
    device busy time (a profiler trace), the round also run once under
    torch.cuda.set_sync_debug_mode("error") with host_syncs held;
  - in PAIRS interleaved pairs, alternating which tree goes first: the
    round's wall time (median of 3 synchronised rounds); per tree the
    median and quartiles over the pairs, and the pairs the change won.

Every turn's outputs (each kernel's, each request's) must equal the first
turn's bit for bit. Writes chiprun_out/ab_parent.json and prints one line
per turn and per metric.
"""
from __future__ import annotations

import importlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)

PKG = "repro_torch"
ORDER = ("parent", "change", "change", "parent")
PAIRS = 20
KERNELS = ("range_count", "circle_count", "knn_topk", "point_in_polygon")


def _own() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def use(mods: dict) -> None:
    """Put one tree's modules in ``sys.modules`` in place of the other's."""
    for k in list(_own()):
        del sys.modules[k]
    sys.modules.update(mods)


def load_tree(src: Path) -> dict:
    """The package ``repro_torch`` of ``src`` (a tree's ``src/``), imported
    beside this tree's, which stays in ``sys.modules``. Returns its
    modules."""
    mine = _own()
    use({})
    sys.path.insert(0, str(src))
    try:
        for name in ("core", "serve", "kernels", "kernels._build",
                     "data.spatial"):
            importlib.import_module(f"{PKG}.{name}")
        theirs = _own()
    finally:
        sys.path.remove(str(src))
        use(mine)
    return theirs


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_parent: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import keys as K

    tree = Path(sys.argv[1]).resolve()
    dev = torch.device(CS.DEVICE)
    card = CS.card_line()
    mods = {"change": None, "parent": load_tree(tree / "src")}
    import repro_torch.core  # noqa: F401  (this tree's, imported whole)
    import repro_torch.kernels._build  # noqa: F401
    import repro_torch.serve  # noqa: F401
    mods["change"] = _own()
    for name in ("parent", "change"):
        use(mods[name])
        built = mods[name][f"{PKG}.kernels._build"].build_all()
        CS.log(f"[ab] {name}: built {sorted(built)}")
    use(mods["change"])

    # the index and the main path's launch arguments, from this tree
    x, y, part, index, _, _ = CS.full_index(dev)
    (_, _, rects, kx, ky, _, cx, cy, cr, polys,
     ne) = CS.main_inputs(x, y, part)
    ex = mods["change"][f"{PKG}.core"].Executor(index, device=dev)
    rect_t = torch.as_tensor(rects, device=dev)
    klo, khi = (K.keys_to_f32(v) for v in K.rect_key_range(rect_t, ex.spec))
    crect, cklo, ckhi, ccirc = ex._circle_args((cx, cy, cr))
    kxt, kyt = (torch.as_tensor(a, device=dev) for a in (kx, ky))
    launch_args = {
        "range_count": CS.count_launch_args(ex, rect_t, klo, khi),
        "circle_count": CS.count_launch_args(ex, crect, cklo, ckhi, ccirc),
        "knn_topk": [(kxt, kyt, ch["count"], ch["x"], ch["y"])
                     for _, ch in mods["change"][
                         f"{PKG}.core.local_ops"]._chunks(
                             ex.parts, ex.cfg.part_chunk)],
        "point_in_polygon": CS.join_launch_args(ex, polys, ne)}
    wrapper = {"range_count": ("range_filter", "range_count", {}),
               "circle_count": ("circle_filter", "circle_count", {}),
               "knn_topk": ("knn_topk", "knn_topk", {"k": 10}),
               "point_in_polygon": ("point_in_polygon", "join_count", {})}

    def kernel_call(name, tree_):
        mod, fn, kw = wrapper[name]
        f = getattr(mods[tree_][f"{PKG}.kernels.{mod}"], fn)
        return lambda: [f(*a, **kw) for a in launch_args[name]]

    sessions, rounds = {}, {}
    for tree_ in ("parent", "change"):
        use(mods[tree_])
        sessions[tree_] = mods[tree_][f"{PKG}.serve"].SpatialServeSession(
            index, device=dev)
        sessions[tree_].warmup(CS.serve_round(x, y, part, 0, dev))
        rounds[tree_] = CS.serve_round(x, y, part, 1, dev)

    def flat(out):
        got = []
        for o in out:
            got += list(o) if isinstance(o, tuple) else [o]
        return got

    turns, first = [], None
    for tree_ in ORDER:
        use(mods[tree_])
        sess, reqs = sessions[tree_], rounds[tree_]
        got = []
        for name in KERNELS:
            for o in kernel_call(name, tree_)():
                got += list(o) if isinstance(o, tuple) else [o]
        got += flat(sess.submit_batch(reqs))
        if first is None:
            first = got
        CS.require(len(got) == len(first) and all(
            torch.equal(a, b) for a, b in zip(got, first)),
            f"{tree_}: outputs differ from the first turn's")
        row = {"tree": tree_, "kernel_ms_per_call": {
            name: CS.stream_ms(kernel_call(name, tree_), 20)
            for name in KERNELS}}
        torch.cuda.synchronize()
        syncs = sess.stats()["host_syncs"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            sess.submit_batch(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        CS.require(sess.stats()["host_syncs"] == syncs,
                   f"{tree_}: a steady serving round read the device")
        row["serve_round_busy_ms"] = sum(CS.device_profile(
            lambda: sess.submit_batch(reqs), 1).values())
        turns.append(row)
        CS.log(f"[ab] {tree_}: ms per call " + ", ".join(
            f"{n} {t:.5f}" for n, t in row["kernel_ms_per_call"].items())
            + f"; serving round busy {row['serve_round_busy_ms']:.3f} ms")

    samples = {"parent": [], "change": []}
    for pair in range(PAIRS):
        for tree_ in (("parent", "change") if pair % 2 == 0
                      else ("change", "parent")):
            use(mods[tree_])
            sess, reqs = sessions[tree_], rounds[tree_]
            samples[tree_].append(CS.host_ms(
                lambda: sess.submit_batch(reqs), 3))
    use(mods["change"])
    q = {t: statistics.quantiles(v, n=4) for t, v in samples.items()}
    won = sum(c < p for p, c in zip(samples["parent"], samples["change"]))
    wall = {"samples": samples, "change_won": won, "pairs": PAIRS,
            **{f"{t}_median": statistics.median(v)
               for t, v in samples.items()},
            **{f"{t}_quartiles": [q[t][0], q[t][2]] for t in q}}
    CS.log(f"[ab] wall serve_round q = {CS.SERVE_Q}: parent median "
           f"{wall['parent_median']:.3f} ms (quartiles {q['parent'][0]:.3f}"
           f"-{q['parent'][2]:.3f}), change {wall['change_median']:.3f} ms "
           f"(quartiles {q['change'][0]:.3f}-{q['change'][2]:.3f}); change "
           f"faster in {won} of {PAIRS} pairs")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_parent.json").write_text(json.dumps(
        {"card": card, "order": ORDER, "turns": turns,
         "wall": {"serve_round": wall}}, indent=1))
    CS.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
