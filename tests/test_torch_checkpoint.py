"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the twins of tests/test_checkpoint.py,
checkpoints that cross between the two packages both ways, the port's
own round trip bitwise with every dtype kept, an asynchronous save whose
source is overwritten in place before the writer joins, the missing-leaf
and shape-mismatch errors, and the placement callable: at world size 1
in this process, and through ``convert.load_index`` on four gloo ranks,
each restoring only its shard for a meshed executor that serves as the
one given the whole index does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.core import build_index as j_build
from repro.core import fit as j_fit
from repro_torch import convert
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    read_meta, restore_or_init, rows_of,
                                    save_checkpoint)
from repro_torch.core import (CircleQuery, DeleteBatch, Executor,
                              InsertBatch, Knn, PointQuery, RangeCount,
                              RangeQuery, SpatialJoin, build_index, fit)
from repro_torch.core import build as TB
from repro_torch.core import local_ops as L
from repro_torch.core.plan import EngineConfig
from repro_torch.data import spatial as ds

torch.set_num_threads(1)
CPU = "cpu"


def _tree(seed=0):
    """The reference test's tree, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    return {"a": torch.as_tensor(rng.standard_normal((4, 8)).astype(
                np.float32)),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "c": torch.tensor(3.5, dtype=torch.float32)}}


def _jtree(seed=0):
    t = _tree(seed)
    return {"a": jnp.asarray(t["a"].numpy()),
            "nested": {"b": jnp.arange(5, dtype=jnp.int32),
                       "c": jnp.float32(3.5)}}


def _meta_like():
    """``_tree``'s shapes and dtypes, nothing allocated."""
    return {"a": torch.empty(4, 8, device="meta"),
            "nested": {"b": torch.empty(5, dtype=torch.int32,
                                        device="meta"),
                       "c": torch.empty((), device="meta")}}


def _assert_tree_equal(want, got):
    for path in ("a", "nested/b", "nested/c"):
        w, g = want, got
        for k in path.split("/"):
            w, g = w[k], g[k]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.numpy().tobytes() == w.numpy().tobytes(), path


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    got = load_checkpoint(str(tmp_path), 7, _meta_like(), device=CPU)
    _assert_tree_equal(t, got)
    assert got["nested"]["c"].dim() == 0


def test_atomicity_ignores_partial_writes(tmp_path):
    save_checkpoint(str(tmp_path), 5, _tree())
    # simulate a crash mid-write: tmp dir + corrupt manifest
    bad = tmp_path / "step_00000009.tmp-123"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    half = tmp_path / "step_00000010"
    half.mkdir()
    (half / "arrays.npz").write_bytes(b"garbage")  # no manifest
    assert latest_step(str(tmp_path)) == 5


def test_restore_or_init_fresh_and_resume(tmp_path):
    tree, step = restore_or_init(str(tmp_path), _tree, device=CPU)
    assert step == 0
    _assert_tree_equal(_tree(), tree)
    save_checkpoint(str(tmp_path), 3, _tree(1))
    save_checkpoint(str(tmp_path), 6, _tree(2))
    calls = []

    def init():                 # the prototype's run allocates nothing
        calls.append(torch.empty(0).device)
        return _tree()

    tree, step = restore_or_init(str(tmp_path), init, device=CPU)
    assert step == 6 and calls == [torch.device("meta")]
    _assert_tree_equal(_tree(2), tree)


def test_async_checkpoint_joins(tmp_path):
    h = save_checkpoint(str(tmp_path), 2, _tree(), async_write=True)
    h.join()
    assert latest_step(str(tmp_path)) == 2


def test_async_save_survives_in_place_writes(tmp_path):
    """The leaves are copied to the host before the writer starts: the
    caller's in-place writes (the update path, CUDA graph planes) right
    after the call do not reach the checkpoint."""
    t = _tree()
    want = {k: v.clone() for k, v in t.items() if k == "a"}
    big = torch.arange(1 << 20, dtype=torch.int64)
    t["big"] = big
    h = save_checkpoint(str(tmp_path), 3, t, async_write=True)
    t["a"].fill_(-1.0)
    big.zero_()
    t["nested"]["b"].add_(100)
    h.join()
    got = load_checkpoint(str(tmp_path), 3, dict(
        _meta_like(), big=torch.empty(1 << 20, dtype=torch.int64,
                                       device="meta")), device=CPU)
    assert torch.equal(got["a"], want["a"])
    assert torch.equal(got["big"], torch.arange(1 << 20, dtype=torch.int64))
    assert got["nested"]["b"].tolist() == [0, 1, 2, 3, 4]


def test_shape_mismatch_detected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad_proto = {"a": torch.empty(3, 3, device="meta"),
                 "nested": {"b": torch.empty(5, dtype=torch.int32),
                            "c": torch.empty(())}}
    with pytest.raises(ValueError, match="shape mismatch for a"):
        load_checkpoint(str(tmp_path), 1, bad_proto, device=CPU)


def test_missing_leaf_detected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    proto = dict(_meta_like(), extra=torch.empty(2))
    with pytest.raises(KeyError, match="checkpoint missing leaf extra"):
        load_checkpoint(str(tmp_path), 1, proto, device=CPU)


def test_default_device_is_the_card(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default loads onto it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(str(tmp_path), 1, _meta_like())


def test_roundtrip_keeps_every_dtype_bitwise(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"f32": torch.as_tensor(rng.standard_normal(7).astype(
                np.float32)),
            "f64": torch.as_tensor(rng.standard_normal((2, 3))),
            "i64": torch.as_tensor(rng.integers(-2**40, 2**40, 9)),
            "i32": torch.as_tensor(rng.integers(-9, 9, (3, 1)).astype(
                np.int32)),
            "u8": torch.arange(4, dtype=torch.uint8),
            "bool": torch.tensor([True, False]),
            "seq": [torch.tensor(1.25), (torch.zeros(0), None)],
            "nan": torch.tensor([float("nan"), -0.0, 1e-45])}
    save_checkpoint(str(tmp_path), 1, tree)
    got = load_checkpoint(str(tmp_path), 1, tree, device=CPU)
    flat = [("f32",), ("f64",), ("i64",), ("i32",), ("u8",), ("bool",),
            ("nan",), ("seq", 0), ("seq", 1, 0)]
    for path in flat:
        w, g = tree, got
        for k in path:
            w, g = w[k], g[k]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.numpy().tobytes() == w.numpy().tobytes(), path
    assert got["seq"][1][1] is None and isinstance(got["seq"][1], tuple)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert sorted(z.files) == ["bool", "f32", "f64", "i32", "i64",
                                   "nan", "seq/0", "seq/1/0", "u8"]


# -- across the two packages ----------------------------------------------

def test_reference_checkpoint_loads_in_the_port(tmp_path):
    j_save(str(tmp_path), 4, _jtree(1))
    got = load_checkpoint(str(tmp_path), 4, _meta_like(), device=CPU)
    _assert_tree_equal(_tree(1), got)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    save_checkpoint(str(tmp_path), 4, _tree(2))
    proto = jax.eval_shape(lambda: _jtree())
    got = j_load(str(tmp_path), 4, proto)
    want = _tree(2)
    assert (np.asarray(got["a"]).tobytes() == want["a"].numpy().tobytes())
    assert np.asarray(got["nested"]["b"]).tolist() == [0, 1, 2, 3, 4]
    assert float(got["nested"]["c"]) == 3.5


@pytest.fixture(scope="module")
def indexes():
    """A small taxi index built by both packages, and the port's."""
    x, y = ds.make("taxi", 6000, seed=4)
    jidx = j_build(x, y, j_fit("kdtree", x, y, 8, seed=1))
    tidx = build_index(x, y, fit("kdtree", x, y, 8, seed=1), device=CPU)
    return jidx, tidx


def _jarrays(jidx):
    import dataclasses
    return {f.name: getattr(jidx, f.name)
            for f in dataclasses.fields(jidx)
            if not f.metadata.get("static")
            and getattr(jidx, f.name) is not None}


def test_index_crosses_both_ways_by_value(tmp_path, indexes):
    """The reference's index arrays (uint32 keys) load into the port's
    int64 prototype by value, and the port's (int64 keys) load through
    the reference's ``load_checkpoint`` into its uint32 prototype."""
    jidx, tidx = indexes
    jarr = _jarrays(jidx)
    tarr, statics = convert.index_to_arrays(tidx)
    assert sorted(jarr) == sorted(tarr)
    j_save(str(tmp_path / "j"), 1, jarr)
    got = load_checkpoint(str(tmp_path / "j"), 1,
                          {k: torch.as_tensor(v) for k, v in tarr.items()},
                          device=CPU)
    for k, v in tarr.items():
        assert got[k].dtype == torch.from_numpy(v).dtype, k
        assert got[k].numpy().tobytes() == v.tobytes(), k
    save_checkpoint(str(tmp_path / "t"), 1, tarr, meta=statics)
    proto = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jarr)
    back = j_load(str(tmp_path / "t"), 1, proto)
    for k, v in jarr.items():
        assert back[k].dtype == v.dtype, k
        assert np.asarray(back[k]).tobytes() == np.asarray(v).tobytes(), k
    meta = read_meta(str(tmp_path / "t"), 1)
    assert meta == statics
    assert meta["leaf_specs"]["key"] == {"shape": list(tarr["key"].shape),
                                     "dtype": "<i8"}
    assert meta["key_spec"]["bounds"] == list(jidx.key_spec.bounds)
    for name in ("eps", "radix_bits", "probe", "overflow_pid", "epoch",
                 "shape_epoch"):
        assert meta[name] == getattr(jidx, name), name


def test_placement_at_world_size_one(tmp_path, indexes):
    """``rows_of`` at a one-rank mesh (gloo) keeps every row: the
    shard ``shard_partitions`` cuts; at an offset it keeps the rows a
    larger mesh's rank would hold; and ``convert.load_index`` on that
    mesh restores the padded shard a meshed ``Executor`` keeps, which
    serves every family as the executor given the whole index does."""
    from repro_torch.launch import mesh as M
    _, tidx = indexes
    tarr, statics = convert.index_to_arrays(tidx)
    save_checkpoint(str(tmp_path), 1, tarr, meta=statics)
    proto = {k: torch.as_tensor(v) for k, v in tarr.items()}
    M.init_process(CPU, init_method=f"file://{tmp_path}/store",
                   world_size=1, rank=0)
    try:
        mesh = M.make_host_mesh(device=CPU)
        axis = mesh.axis("data")
        p = tidx.num_partitions
        p_loc = p // axis.size
        place = rows_of(axis.offset(p_loc), p_loc, skip=("part_bounds",))
        got = load_checkpoint(str(tmp_path), 1, proto, device=CPU,
                              place=place)
        shard = convert.load_index(str(tmp_path), device=CPU, mesh=mesh)
        assert (shard.part_offset, shard.part_total,
                shard.num_partitions) == (0, 16, 16)
        whole = Executor(tidx, device=CPU, mesh=mesh)
        cut = Executor(shard, device=CPU, mesh=mesh)
        _same_shard_service(whole, cut, tidx.x[tidx.vid >= 0].numpy(),
                            tidx.y[tidx.vid >= 0].numpy())
        with pytest.raises(ValueError, match="not this rank's"):
            Executor(shard, EngineConfig(part_chunk=32), device=CPU,
                     mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    want = L.shard_partitions(tidx, 0, p_loc)
    for k in tarr:
        assert torch.equal(got[k], getattr(want, k)), k
    # a rank of a two-shard mesh: rows [4, 8) of 9 and the boxes whole
    half = load_checkpoint(str(tmp_path), 1, proto, device=CPU,
                           place=rows_of(4, 4, skip=("part_bounds",)))
    cut = L.shard_partitions(tidx, 4, 4)
    for k in tarr:
        assert torch.equal(half[k], getattr(cut, k)), k
        assert half[k].is_contiguous(), k
    assert half["part_bounds"].shape[0] == p


def test_load_index_unmeshed(tmp_path, indexes):
    """``convert.load_index`` without a mesh restores the whole index,
    the newest step by default, leaf for leaf; an empty directory has
    none."""
    _, tidx = indexes
    with pytest.raises(FileNotFoundError):
        convert.load_index(str(tmp_path), device=CPU)
    tarr, statics = convert.index_to_arrays(tidx)
    save_checkpoint(str(tmp_path), 3, tarr, meta=statics)
    back = convert.load_index(str(tmp_path), device=CPU)
    for k, v in tarr.items():
        assert getattr(back, k).numpy().tobytes() == v.tobytes(), k
        assert getattr(back, k).dtype == getattr(tidx, k).dtype, k
    assert back.key_spec == tidx.key_spec and back.part_total == 0


def _sweep(x, y):
    """(spec, args) of every query family at a shard test's size."""
    rng = np.random.default_rng(53)
    ix = rng.integers(0, len(x), 10)
    qx = np.concatenate([x[ix[:6]], rng.random(4).astype(np.float32)])
    qy = np.concatenate([y[ix[:6]], rng.random(4).astype(np.float32)])
    rects = ds.random_rects(10, 1e-3, (0, 0, 1, 1), seed=59,
                            centers=(x, y))
    r = np.full(10, 0.02, np.float32)
    polys, ne = ds.random_polygons(4, (0, 0, 1, 1), seed=61)
    return [(PointQuery(), qx, qy), (RangeCount(), rects),
            (RangeQuery(), rects), (CircleQuery(), qx, qy, r),
            (Knn(k=5), qx, qy), (Knn(k=5, mode="exact"), qx, qy),
            (SpatialJoin(), polys, ne),
            (SpatialJoin(mode="full"), polys, ne)]


def _same_shard_service(whole, cut, x, y):
    """Two meshed executors, one given the whole index and one this
    rank's restored shard, hold the same rows and the same statics,
    answer every family bitwise, and number an insert alike."""
    assert (cut.p_total, cut.next_vid) == (whole.p_total, whole.next_vid)
    for name in TB.LEAVES:
        u, v = getattr(whole.index, name), getattr(cut.index, name)
        assert (u is None) == (v is None), name
        if u is not None:
            assert u.dtype == v.dtype and torch.equal(u, v), name
    for name in ("part_offset", "part_total", "overflow_pid", "epoch",
                 "shape_epoch"):
        assert getattr(whole.index, name) == getattr(cut.index, name), name
    for spec, *args in _sweep(x, y):
        a = whole.run(spec, *args, strict=True)
        b = cut.run(spec, *args, strict=True)
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert u.numpy().tobytes() == v.numpy().tobytes(), spec
    bx = np.linspace(0.1, 0.9, 7, dtype=np.float32)
    va = whole.run(InsertBatch(), bx, bx[::-1].copy())
    vb = cut.run(InsertBatch(), bx, bx[::-1].copy())
    assert np.array_equal(va, vb)


def _shard_rank(ckpt_root: str, rank: int, world: int, init: str) -> None:
    """One rank of ``test_meshed_ranks_restore_their_shards``: for the
    frozen and the mutated checkpoint, a meshed executor on the whole
    index against one on this rank's restored shard."""
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    M.init_process(CPU, init_method=init, world_size=world, rank=rank)
    try:
        mesh = M.make_host_mesh((world,), ("data",), device=CPU)
        for name in ("frozen", "mutated"):
            d = f"{ckpt_root}/{name}"
            whole = convert.load_index(d, device=CPU)
            shard = convert.load_index(d, device=CPU, mesh=mesh)
            live = whole.vid >= 0
            _same_shard_service(Executor(whole, device=CPU, mesh=mesh),
                                Executor(shard, device=CPU, mesh=mesh),
                                whole.x[live].numpy(), whole.y[live].numpy())
            if name == "frozen":
                # saved without an overflow id: the last partition's id
                # is global, not the shard's last row
                no_pid = convert.load_index(f"{ckpt_root}/no_pid",
                                            device=CPU, mesh=mesh)
                assert no_pid.overflow_pid == whole.overflow_pid == 8
            print(f"rank {rank} {name}: rows {shard.part_offset}.."
                  f"{shard.part_offset + shard.num_partitions} of "
                  f"{shard.part_total}, ok", flush=True)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def test_meshed_ranks_restore_their_shards(tmp_path, indexes):
    """Four gloo ranks restore their shards of a frozen and of a mutated
    index (delta leaves, tombstones, both epochs) from one checkpoint
    each: 9 partitions padded to 32, so rank 1 holds one real row and
    ranks 2 and 3 none. Each rank's executor on its shard matches the
    one given the whole index (``_same_shard_service``), and a
    checkpoint saved without an overflow id gives every shard the
    global one."""
    import os
    import subprocess
    import sys
    _, tidx = indexes
    ex = Executor(tidx, device=CPU)
    rng = np.random.default_rng(67)
    bx = rng.random(200).astype(np.float32)
    by = rng.random(200).astype(np.float32)
    ex.run(InsertBatch(), bx, by)
    live = tidx.vid >= 0
    ex.run(DeleteBatch(), np.concatenate([tidx.x[live][:90].numpy(),
                                          bx[:30]]),
           np.concatenate([tidx.y[live][:90].numpy(), by[:30]]))
    mut = ex.index
    assert mut.delta_cap > 0 and mut.epoch == 2
    for name, idx in (("frozen", tidx), ("mutated", mut)):
        arrays, statics = convert.index_to_arrays(idx)
        save_checkpoint(str(tmp_path / name), 1, arrays, meta=statics)
    arrays, statics = convert.index_to_arrays(tidx)
    save_checkpoint(str(tmp_path / "no_pid"), 1, arrays,
                    meta=dict(statics, overflow_pid=-1))
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(tests), "src"), tests]))
    init = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from test_torch_checkpoint import _shard_rank; "
         "_shard_rank(sys.argv[1], int(sys.argv[2]), 4, sys.argv[3])",
         str(tmp_path), str(r), init],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    assert "rows 8..16 of 32" in outs[1] and "rows 24..32 of 32" in outs[3]
