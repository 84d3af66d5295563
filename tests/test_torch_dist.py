"""The port's meshed executor (DESIGN.md §6), the twin of
tests/test_engine_dist.py: four gloo ranks on the CPU, each a process of
its own (tests/_dist_worker.py), against the JAX reference at the same
mesh on four fake CPU devices, and against the unmeshed port.

Meshes, as the reference test's ``(8,)`` and ``(2, 4)`` cut to four
ranks: ``(4,)`` over "data", and ``(2, 2)`` over ("pod", "data"), the
partitions sharded over both (the ("data", "query") mesh is
test_torch_query_shard.py's). Every read family (point, range count,
range query, circle count and query, pruned and exact kNN, windowed and
full join) strict at 40 rows and 20 polygons, then serving: at 40 rows
(the bucketed dispatch with its need probes) for range query on
``(4,)`` and for kNN on ``(2, 2)``, at 16 for the others; on taxi 8,000
points over 8 kdtree boxes:

* every rank returns the same outputs;
* they are bitwise the reference's at the same mesh: counts, ok flags,
  materialized ids in their gathered order, kNN distances and ids;
* against the unmeshed port: bitwise, or by DESIGN.md §10's compaction
  rule for materialized ids and kNN ties;
* a point held both in its grid partition and in the overflow grid,
  which lie on two shards, sums to 2 before PointQuery's ``> 0``, as
  the reference's ``psum`` does;
* the precompile worker and the scheduler refuse a world of 4 ranks.

In-process, first, while the ranks run: the merge seam's identities at
``axis=None`` and its collectives at world size 1 (gloo), and a
world-size-1 meshed executor bitwise the unmeshed one.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _dist_worker as W  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.core import build_index, fit  # noqa: E402
from repro_torch.core import local_ops as L  # noqa: E402
from repro_torch.data import spatial as ds  # noqa: E402

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

MESHES = ("4", "2x2pd")


# -- in-process: the seam, world size 1 --------------------------------------

def test_seam_is_the_identity_without_an_axis():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert L._psum(x, None) is x and L._pmax(x, None) is x
    assert L._gather1(x, None) is x and L._offset(None, 7) == 0
    ok = torch.tensor([True, False])
    assert L._ok_merge(ok, None) is ok
    pids = torch.tensor([[0, 5]])
    valid = torch.tensor([[True, False]])
    assert L._local(pids, valid, None, 4) == (pids, valid)
    neg = torch.tensor([[1.0, 2.0]])
    assert L._topk_gathered(neg, x, 2, None) == (neg, x)


@pytest.fixture
def world_one(tmp_path):
    """A gloo process group of one rank in this process, torn down
    after the test."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    assert not dist.is_initialized()
    M.init_process("cpu", init_method=f"file://{tmp_path / 'store'}",
                   world_size=1, rank=0)
    try:
        yield M
    finally:
        dist.destroy_process_group()


def test_seam_collectives_at_world_size_one(world_one):
    M = world_one
    mesh = M.make_host_mesh((1,), ("data",), device="cpu")
    ax = mesh.axis("data")
    assert (ax.size, ax.index, ax.offset(16)) == (1, 0, 0)
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    n0 = M.launches
    s = L._psum(x, ax)
    assert torch.equal(s, x) and s is not x       # issued, not skipped
    assert torch.equal(L._pmax(x, ax), x)
    assert torch.equal(L._gather1(x, ax), x)
    assert torch.equal(ax.all_gather0(x), x)
    ok = torch.tensor([True, False])
    assert torch.equal(L._ok_merge(ok, ax), ok)
    assert ax.agree([3, 1]) == [3, 1] and ax.agree([2], "sum") == [2]
    assert M.launches == n0 + 7
    pids = torch.tensor([[0, 3]])
    local, mine = L._local(pids, torch.tensor([[True, True]]), ax, 2)
    assert local.tolist() == [[0, 1]] and mine.tolist() == [[True, False]]


def test_meshed_executor_at_world_size_one_matches_unmeshed(world_one):
    """A (1,) partition mesh and a (1, 1) partition x query mesh (every
    batch query-sharded): point, range count, range query, kNN and join,
    strict and serving, bitwise the unmeshed executor; the query-axis
    wrappings are cached; a mesh axis that is not the mesh's is
    refused."""
    M = world_one
    x, y, part, qx, qy, rects, r, polys, ne = W.scenario_data(ds, fit)
    idx = build_index(x, y, part, device="cpu")
    cfg = T.EngineConfig(query_shard_threshold=W.QSHARD_THRESHOLD)
    calls = W.query_calls(T, qx, qy, rects, r, polys, ne, n=16, pg=8,
                          only=W.QSHARD_FAMILIES)
    want = {}
    W.run_calls(T.Executor(idx, cfg, device="cpu"), calls, want,
                lambda t: t.numpy())
    for shape, names, qaxis in (((1,), ("data",), None),
                                ((1, 1), ("data", "query"), "query")):
        mesh = M.make_host_mesh(shape, names, device="cpu")
        ex = T.Executor(idx, cfg, device="cpu", mesh=mesh,
                        part_axis="data", query_axis=qaxis)
        got = {}
        W.run_calls(ex, calls, got, lambda t: t.numpy())
        for name, *_ in calls:
            assert W.same(W.outputs(got, name), W.outputs(want, name)), name
        assert (ex.stats()["qshard_executables"] > 0) == (qaxis is not None)
    with pytest.raises(ValueError):
        T.Executor(idx, cfg, device="cpu", mesh=mesh, part_axis="pod")


def test_precompiler_and_scheduler_refuse_a_world_above_one():
    """In-process: an executor whose mesh spans two ranks (a stand-in
    object: the refusal reads only its size) refuses the precompile
    worker and the scheduler; one rank is allowed."""
    from types import SimpleNamespace

    from repro_torch.serve.scheduler import SpatialScheduler
    x, y = ds.make("taxi", 2000, seed=1)
    ex = T.Executor(build_index(x, y, fit("kdtree", x, y, 4), device="cpu"),
                    device="cpu")
    ex.mesh = SimpleNamespace(size=2)
    with pytest.raises(ValueError, match="2 ranks"):
        ex.start_precompiler()
    with pytest.raises(ValueError, match="2 ranks"):
        SpatialScheduler(ex, start=False)
    ex.mesh = SimpleNamespace(size=1)
    SpatialScheduler(ex, start=False).close()


# -- four ranks per mesh ----------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """Every mesh's four ranks and reference, started with the module's
    first test: the in-process tests above run while they do."""
    procs = W.spawn("queries", MESHES, str(tmp_path_factory.mktemp("dist")))
    yield procs
    procs.close()


@pytest.fixture(scope="module")
def runs(spawned):
    """The spawned outputs, and the unmeshed port's, computed here
    meanwhile: {serving rows: outputs}."""
    x, y, part, qx, qy, rects, r, polys, ne = W.scenario_data(ds, fit)
    cfg = T.EngineConfig(query_shard_threshold=W.QSHARD_THRESHOLD)
    idx = build_index(x, y, part, device="cpu")
    wide = {f for fams in W.WIDE.values() for f in fams}
    plain = {16: {}, 40: {}}
    for rows, only in ((16, W.FAMILIES), (40, wide)):
        # the wide families' strict calls again: they settle the tiers
        W.run_calls(T.Executor(idx, cfg, device="cpu"), W.query_calls(
            T, qx, qy, rects, r, polys, ne, serve_n=rows, only=only),
            plain[rows], lambda t: t.numpy())
    return spawned(), plain


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_agree(runs, mesh):
    ranks = runs[0][mesh][1]
    for d in ranks[1:]:
        assert set(d) == set(ranks[0])
        for k in d:
            assert np.array_equal(d[k], ranks[0][k]), k


@pytest.mark.parametrize("name", W.CALLS)
@pytest.mark.parametrize("mesh", MESHES)
def test_matches_reference_at_the_same_mesh(runs, mesh, name):
    ref, ranks = runs[0][mesh]
    got = W.outputs(ranks[0], name)
    assert got is not None, ranks[0].get(name + "/raised")
    want = W.outputs(ref, name)
    assert want is not None, ref[name + "/raised"]
    assert W.same(got, want), name


@pytest.mark.parametrize("name", W.CALLS)
@pytest.mark.parametrize("mesh", MESHES)
def test_matches_unmeshed_port(runs, mesh, name):
    got = W.outputs(runs[0][mesh][1][0], name)
    family, form = name.split("/")
    plain = runs[1][W.serve_rows(mesh, family) if form == "serving" else 16]
    assert W.compaction_same(got, W.outputs(plain, name)), name


def test_point_in_two_shards_answers_two(runs):
    """On the (4,) mesh grid box 0 (shard 0) and the overflow grid (shard
    1) both hold the last query point: the merged flag is 2, the
    reference's too; the found flags are the reference's."""
    ref, ranks = runs[0]["4"]
    sums = ranks[0]["point2/sums"]
    assert sums.tolist() == ref["point2/sums"].tolist()
    assert sums[-1] == 2 and sums.dtype == np.int32
    assert W.same(W.outputs(ranks[0], "point2/strict"),
                  W.outputs(ref, "point2/strict"))


@pytest.mark.parametrize("mesh", MESHES)
def test_counters_match_reference(runs, mesh):
    ref, ranks = runs[0][mesh]
    for k in ("epoch", "shape_epoch", "host_syncs", "n_pad", "next_vid",
              "delta_cap"):
        assert ranks[0][f"stats/{k}"] == ref[f"stats/{k}"], k
    assert ranks[0]["stats/qshard_executables"] == 0


def test_precompiler_and_scheduler_refuse_four_ranks(runs):
    d = runs[0]["4"][1][0]
    assert "4 ranks" in str(d["refuse/precompiler"])
    assert "4 ranks" in str(d["refuse/scheduler"])
