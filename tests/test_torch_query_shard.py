"""Query-axis sharding (DESIGN.md §10), the twin of
tests/test_query_shard.py: a batch at or above
``EngineConfig.query_shard_threshold`` runs the query-sharded wrapping
(``plan.exec_key``'s qshard flag) of each program on a (2, 2) ("data",
"query") mesh of four gloo ranks (tests/_dist_worker.py), and returns
the unsharded result on every rank.

* Unpadded (40 rows and 20 polygons strict, 16 rows serving; the
  reference test's families: point, range count, range query, kNN,
  join): bitwise the JAX reference at the same mesh wherever it runs (it
  raises at some serving calls' un-pad, ROADMAP §3), and the unmeshed
  port.
* Padded (41 rows and 19 polygons strict, 17 rows serving; row 0
  repeated, then un-padded; the reference's 42 and 18 are multiples of
  this 2-way query axis), the same families: the reference raises at
  the un-pad (ROADMAP §3; shown on the point and the join), so the
  unmeshed port decides: bitwise, or DESIGN.md §10's compaction rule
  for materialized ids and kNN ties.
* The cached programs carry the qshard flag, ``qshard_executables``
  counts them, a below-threshold batch runs the unsharded wrapping, and
  the fused serving path makes no host sync.
* ``manifest()``/``prewarm()`` carry the query-sharded programs to a
  second executor.
* A query axis without a mesh, or shared with the partition axis, is
  refused.
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
from repro_torch.data import spatial as ds  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The mesh's four ranks and reference, spawned once for this file
    and test_torch_updates.py's sharded updates; the unmeshed port's
    outputs computed here meanwhile."""
    wait = W.spawn_once(W.MESH_2X2DQ, ("2x2dq",), tmp_path_factory)
    x, y, part, qx, qy, rects, r, polys, ne = W.scenario_data(ds, fit)
    ex = T.Executor(build_index(x, y, part, device="cpu"), device="cpu")
    plain = {}
    W.run_calls(ex, W.query_calls(T, qx, qy, rects, r, polys, ne,
                                  serve_n=16,
                                  only=W.QSHARD_FAMILIES) +
                W.query_calls(T, qx, qy, rects, r, polys, ne, n=41, pg=19,
                              tag="pad_", serve_n=W.PAD_SERVE,
                              only=W.QSHARD_FAMILIES), plain,
                lambda t: t.numpy())
    W.run_calls(ex, [("fused/range_query", T.RangeQuery(), (rects[:16],),
                      True)], plain, lambda t: t.numpy())
    ref, ranks = wait()["2x2dq"]
    return ref, ranks, plain


def test_ranks_agree(runs):
    ranks = runs[1]
    for d in ranks[1:]:
        assert set(d) == set(ranks[0])
        for k in d:
            assert np.array_equal(d[k], ranks[0][k]), k


UNPADDED = tuple(c for c in W.CALLS if c.split("/")[0] in W.QSHARD_FAMILIES)
PADDED = tuple("pad_" + c for c in UNPADDED)


@pytest.mark.parametrize("name", UNPADDED)
def test_unpadded_matches_reference_and_unmeshed(runs, name):
    ref, ranks, plain = runs
    got = W.outputs(ranks[0], name)
    want = W.outputs(ref, name)
    if want is not None:
        assert W.same(got, want), name
    else:       # the reference raises at this serving call's un-pad
        assert name.endswith("/serving"), ref[name + "/raised"]
    assert W.compaction_same(got, W.outputs(plain, name)), name


@pytest.mark.parametrize("name", PADDED)
def test_padded_matches_unmeshed(runs, name):
    ref, ranks, plain = runs
    got = W.outputs(ranks[0], name)
    assert got is not None, ranks[0].get(name + "/raised")
    if name in W.REF_PADDED:            # the reference raised there
        assert W.outputs(ref, name) is None
    assert W.compaction_same(got, W.outputs(plain, name)), name


def test_padded_batches_raise_in_the_reference(runs):
    """The reason the unmeshed port decides the padded cases: the
    reference raises there (its un-pad of a query-sharded output), on
    the point and the join it is given."""
    ref = runs[0]
    assert all(n + "/raised" in ref for n in W.REF_PADDED)


def test_cache_keys_carry_the_qshard_flag(runs):
    d = runs[1][0]
    qkeys = list(d["keys/qshard"])
    assert qkeys and any("'point'" in k for k in qkeys)
    assert int(d["stats/qshard_executables"]) == len(qkeys)


def test_below_threshold_runs_the_unsharded_wrapping(runs):
    ref, ranks, _ = runs
    d = ranks[0]
    assert int(d["keys/below_point"]) == 1
    assert W.same(W.outputs(d, "below/point"), W.outputs(ref, "below/point"))


def test_fused_serving_path_makes_no_host_sync(runs):
    ref, ranks, plain = runs
    d = ranks[0]
    assert int(d["fused/host_syncs"]) == 0
    got = W.outputs(d, "fused/range_query")
    assert W.same(got[:1], W.outputs(plain, "fused/range_query")[:1])
    if W.outputs(ref, "fused/range_query") is not None:
        assert W.same(got, W.outputs(ref, "fused/range_query"))


def test_manifest_prewarms_the_query_sharded_programs(runs):
    """A second executor on the same mesh realizes every recorded
    program, the query-sharded ones included (none skipped), and its
    exercised families run through the same wrappings."""
    d = runs[1][0]
    assert int(d["prewarm/skipped"]) == 0
    assert int(d["prewarm/programs"]) > 0
    assert set(d["keys/qshard_full"]) <= set(d["prewarm/qshard_keys"])


def test_query_axis_validation():
    x, y = ds.make("taxi", 2000, seed=1)
    idx = build_index(x, y, fit("kdtree", x, y, 4), device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        T.Executor(idx, device="cpu", query_axis="query")
    with pytest.raises(ValueError, match="overlaps part_axis"):
        # validated before the mesh is touched
        T.Executor(idx, device="cpu", mesh=object(), part_axis="data",
                   query_axis="data")
    with pytest.raises(ValueError, match="overlaps part_axis"):
        T.Executor(idx, device="cpu", mesh=object(),
                   part_axis=("pod", "data"), query_axis=("data",))
