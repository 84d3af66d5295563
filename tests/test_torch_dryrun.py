"""The port's production-mesh dry run (``repro_torch.launch.
dryrun_spatial``): at full size on both meshes in a subprocess (the
fake process group is process-global), exit 0, eight reports with rank
0's shard of 256 and 128 partition rows, and no full-size allocation;
each report held against the reference's dry run (its index, its
sizes, and its four programs' output shapes traced by ``jax.eval_shape``
under ``shard_map`` over the same mesh, nothing lowered); the byte
tally and the collective log it reports from; and
``make_production_mesh``'s error at a world of one rank."""
import dataclasses
import functools
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun_spatial as D
from repro_torch.launch import mesh as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = ("range_mask", "range_window", "knn10", "join")


# python -m repro_torch.launch.dryrun_spatial, then its own peak RSS
RUN = ("import resource, runpy, sys\n"
       "sys.argv = ['dryrun_spatial'] + sys.argv[1:]\n"
       "try:\n"
       "    runpy.run_module('repro_torch.launch.dryrun_spatial',\n"
       "                     run_name='__main__')\n"
       "finally:\n"
       "    print('PEAK_RSS_KB',\n"
       "          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n")


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", RUN, "--mesh", "both", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    peak = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("PEAK_RSS_KB")]
    return proc, out, int(peak[0].split()[1]) if peak else None


def test_dryrun_both_meshes_exits_zero(dryrun):
    proc, out, peak_kb = dryrun
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    names = sorted(os.path.basename(p) for p in glob.glob(f"{out}/*.json"))
    assert names == sorted(f"lilis-spatial__{p}__{m}.json"
                           for p in PROGRAMS for m in ("single", "multi"))
    # one (4096, 262144) int64 key plane alone is 8 GiB
    assert peak_kb < 4 * 1024 * 1024, peak_kb
    assert proc.stdout.count("OK   spatial/") == 8


@pytest.mark.parametrize("mesh,chips,axis,rows", [
    ("single", 256, ["data"], 256), ("multi", 512, ["pod", "data"], 128)])
def test_dryrun_per_rank_reports(dryrun, mesh, chips, axis, rows):
    _, out, _ = dryrun
    want_out = {"range_mask": [[1024]],
                "range_window": [[1024], [1024, 512], [1024]],
                "knn10": [[1024, 10], [1024, 10], [1024]],
                "join": [[256], [256]]}
    for prog in PROGRAMS:
        with open(f"{out}/lilis-spatial__{prog}__{mesh}.json") as f:
            rep = json.load(f)
        pr = rep["per_rank"]
        assert (rep["arch"], rep["shape"], rep["mesh"], rep["chips"]) == \
            ("lilis-spatial", prog, mesh, chips)
        assert rep["points"] == 4096 * 262144
        assert rep["query_shard_threshold_src"] == "default"
        assert pr["part_axis"] == axis and pr["partition_rows"] == rows
        assert pr["shard_bytes"]["key"] == rows * 262144 * 8
        assert pr["shard_bytes"]["part_bounds"] == 4096 * 4 * 4
        assert pr["outputs"] == want_out[prog]
        # every program merges over the part axis
        assert pr["collectives"] and all(
            c["axis_size"] == 4096 // rows for c in pr["collectives"])
        assert pr["plain_bytes_read"] > 0 and pr["plain_bytes_written"] > 0
        assert pr["t_memory_s"] == pytest.approx(
            (pr["plain_bytes_read"] + pr["plain_bytes_written"]) / 3.35e12)
    with open(f"{out}/lilis-spatial__range_mask__{mesh}.json") as f:
        coll = json.load(f)["per_rank"]["collectives"]
    assert coll == [{"op": "all_reduce", "axis_size": 4096 // rows,
                     "bytes": 1024 * 4}]


def _reference():
    """The reference's ``launch/dryrun_spatial`` module, imported without
    its device-count flag leaking into this process's later children."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun_spatial as R
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return R


def reference_outputs(mesh_kind: str) -> dict:
    """The output shapes of the reference's four programs as its dry run
    builds them (``cfg``, ``fake_index``, the query shapes), the
    partitions sharded over the production mesh's part axis: traced by
    ``jax.eval_shape`` of the ``shard_map``-ed program over an abstract
    mesh of that shape, so nothing is lowered or allocated."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as P

    import repro.core.local_ops as E
    from repro.core.backends import resolve_backend
    from repro.core.plan import EngineConfig
    R = _reference()
    multi = mesh_kind == "multi"
    mesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                        ("pod", "data", "model") if multi
                        else ("data", "model"))
    axes = ("pod", "data") if multi else ("data",)
    idx = R.fake_index()
    cfg = EngineConfig(part_chunk=8, range_cap=64, knn_cap=64,
                       range_cand=8, knn_cand=8, join_cap=128,
                       join_cand=8, backend="xla")
    bk = resolve_backend("xla")
    sd = jax.ShapeDtypeStruct
    parts = {"keys_f": sd((R.P_TOTAL, R.N_PAD), jnp.float32)}
    parts.update({k: getattr(idx, k) for k in (
        "x", "y", "vid", "count", "knot_keys", "knot_pos", "n_knots",
        "radix_table", "radix_kmin", "radix_scale")})
    f32 = jnp.float32
    rq = (sd((R.Q, 4), f32), sd((R.Q,), f32), sd((R.Q,), f32))
    programs = {
        "range_mask": (E._RangeCountLocal(idx, cfg, bk), rq),
        "range_window": (E._RangeWindowLocal(idx, cfg, bk, cfg.range_cap,
                                             cfg.range_cand), rq),
        "knn10": (E._KnnPrunedLocal(idx, cfg, bk, 10, idx.key_spec,
                                    cfg.knn_cand, cfg.knn_cap),
                  (sd((R.Q,), f32), sd((R.Q,), f32), sd((R.Q,), f32))),
        "join": (E._JoinLocal(idx, cfg, bk, cfg.join_cap, cfg.join_cand),
                 (sd((R.PG, 16, 2), f32), sd((R.PG,), jnp.int32),
                  sd((R.PG, 6), f32)))}
    out = {}
    for name, (fn, q) in programs.items():
        prog = jax.shard_map(functools.partial(fn, axis=axes), mesh=mesh,
                             in_specs=(P(axes),) + (P(),) * (len(q) + 1),
                             out_specs=P(), check_vma=False)
        res = jax.eval_shape(prog, parts, idx.part_bounds, *q)
        out[name] = [list(a.shape) for a in jax.tree_util.tree_leaves(res)]
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_matches_the_reference_dryrun(dryrun, mesh):
    """Each report against the reference's dry run on the same mesh: its
    sizes, its index cut to rank 0's rows leaf by leaf (keys int64 here,
    uint32 there, by design), and every program's output shapes."""
    _, out, _ = dryrun
    R = _reference()
    for name in ("P_TOTAL", "N_PAD", "M_PAD", "RADIX_BITS", "Q", "PG"):
        assert getattr(D, name) == getattr(R, name), name
    ref_idx = R.fake_index()
    chips = 512 if mesh == "multi" else 256
    rows = R.P_TOTAL // (32 if mesh == "multi" else 16)
    want = reference_outputs(mesh)
    for prog in PROGRAMS:
        with open(f"{out}/lilis-spatial__{prog}__{mesh}.json") as f:
            rep = json.load(f)
        assert rep["chips"] == chips and rep["points"] == R.P_TOTAL * R.N_PAD
        assert rep["queries"] == (R.PG if prog == "join" else R.Q)
        pr = rep["per_rank"]
        assert pr["partition_rows"] == rows
        assert set(pr["shard_bytes"]) == {
            f.name for f in dataclasses.fields(ref_idx)
            if hasattr(getattr(ref_idx, f.name), "shape")}
        for leaf, nbytes in pr["shard_bytes"].items():
            a = getattr(ref_idx, leaf)
            size = 8 if leaf == "key" else np.dtype(a.dtype).itemsize
            keep = a.shape[0] if leaf == "part_bounds" else rows
            assert nbytes == keep * int(np.prod(a.shape[1:])) * size, leaf
        assert pr["outputs"] == want[prog], prog


def test_byte_tally_counts_reads_and_writes():
    a = torch.empty(1024, device="meta")
    b = torch.empty(1024, device="meta")
    with D.ByteTally() as t:
        c = a + b
        c.view(32, 32)                  # a view moves nothing
        c[:10].sum()
    assert t.ops == 2
    assert t.read == 8192 + 40 and t.written == 4096 + 4


def test_production_mesh_needs_its_world():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="need a world of 256 ranks"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need a world of 512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")


def test_dryrun_refuses_the_cuda_backend(capsys):
    with pytest.raises(SystemExit) as e:
        D.main(["--backend", "cuda", "--out", "unused"])
    assert e.value.code == 2
    assert "cannot run on meta" in capsys.readouterr().err
