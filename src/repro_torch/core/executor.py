"""Query executor: runs QuerySpecs against one LearnedSpatialIndex on
one device, or as one rank of a mesh.

Exact specs run one local program (core/local_ops.py): PointQuery ->
_PointLocal, RangeCount -> _RangeCountLocal, Knn(mode="exact") ->
_KnnExactLocal, SpatialJoin(mode="full") -> _JoinFullLocal.

Adaptive specs (RangeQuery, CircleQuery, pruned Knn, windowed
SpatialJoin) share one policy (paper §4, DESIGN.md §7), in
``_adaptive``:

* strict (``strict=True``, or no sticky tier yet): start from the spec
  family's sticky (cap, cand) tier (or the initial one), run the
  windowed program, read its ok flags on the host (``_all_ok``, counted
  in ``host_syncs``), escalate until every query is ok or the tier is
  maxed, then fall back to the exact program where the family has one.
  The tier that succeeded becomes the family's sticky tier, keyed by
  ``spec.sticky_key()``.
* serving (``strict=False`` on a sticky tier): one fused program
  (``local_ops._CondFusedLocal``) runs the windowed attempt at the
  sticky tier and the exact fallback on the device, with no host read;
  its ok flags are stashed, unread, for ``maintain()``, which re-tunes
  the tiers off the hot path (escalation, demotion, back-off).
* wide serving (``strict=False`` on a sticky tier, at least
  ``tier_bucket_min`` queries): the tier-bucketed dispatch
  (``_run_bucketed``, DESIGN.md §13). A need probe ranks every row on
  the device, one host read brings back the bucket sizes (counted in
  ``probe_syncs``, not ``host_syncs``), and each bucket runs the fused
  program at the lowest tier its rows fit, scattered back in request
  order: bitwise one sticky-tier call.

Update specs (InsertBatch, DeleteBatch, Refit; DESIGN.md §11) mutate
the resident index through the same ``run``: inserts append to the
partitions' delta buffers, deletes tombstone in place, and a re-fit
compacts the touched partitions (``core/mutate.py``). They are
host-driven and may read the host; a query after them still makes no
host read on the serving path. An update whose partition's delta
occupancy passes ``EngineConfig.delta_occupancy`` schedules a re-fit,
which ``maintain()`` runs off the hot path.

Programs are cached as the reference caches its executables (DESIGN.md
§14): ``_compile(exec_key, make_fn)`` keeps one ``_Dispatch`` per key,
which realizes the program once per argument signature. On the card a
query program's realization is a CUDA graph (``_Graph``), so a steady
call launches the whole program at once instead of op by op from
Python. A signature's first call runs eagerly and only its second is
captured (and replayed from then on), so a batch width seen once costs
no capture and holds no graph memory. The eviction rules are the reference's: a sticky move
drops the superseded window tiers (``_evict``), a shape-epoch bump drops
every program of the old shapes (``_evict_stale``); ``release()`` drops
every program and gives the graphs' memory back. With graphs on,
mutations write the executor's own copy of the partition planes in
place where their shape holds, so a graph keeps reading the live index;
each replay also checks the planes' pointers and captures again if one
moved. ``manifest()`` records every
realized (exec_key, signature) and ``prewarm()`` realizes them in
another executor or process. With ``EngineConfig.compile_cache_dir``,
the CUDA kernel libraries are kept on disk (core/compile_cache.py).

Multi-GPU (DESIGN.md §6, §10) is SPMD over ``torch.distributed``: one
process per rank, each making the same calls with the same arguments
(``launch/mesh.py``). With ``mesh`` the partitions shard over
``part_axis``: the index is padded to shards x ``part_chunk``
partitions, each rank keeps its own rows on its device (the boxes, the
overflow id and the statics stay global; an index that is already this
rank's shard, as ``convert.load_index`` restores it from a checkpoint,
is taken as it is) and every program merges its
share with the axis's collectives (core/local_ops.py). With
``query_axis`` too, a batch of at least ``query_shard_threshold``
queries is padded to a multiple of the query axis by repeating row 0;
each rank runs its row block, and the outputs are gathered over the
query axis and un-padded, so every rank returns the whole result
(``_QShard``; exec_key ``qshard=True``). Updates reach every rank whole:
each applies the rows of its own partitions, and every shape static is
agreed by a collective before it is installed, so every rank bumps
``shape_epoch`` together. NCCL collectives are captured in the CUDA
graphs like the kernels (their communicators are created eagerly, at
construction). The scheduler and the precompile worker refuse a world
of more than one rank: their batches and captures follow thread timing,
which differs from rank to rank.

The precompile worker (``start_precompiler``; the serve scheduler starts
it in worker mode when ``EngineConfig.serve_async_precompile``) moves
captures off the serving thread: it captures the tier above sticky and
the demotion target after a sticky move, each (spec, width) the
scheduler hands over (``precompile_async``), and each signature met for
the second time, which meanwhile runs eagerly. It captures on its own
stream, outside the executor lock, and installs a graph under the lock
only if its program is still cached at the same shape epoch. Every
capture of an executor, on either thread, holds the capture lock, and
no graph is destroyed while one is open (``_retire``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import threading
import time
import weakref
from contextlib import contextmanager
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch._num import (flush_denormals, mul_f32, resolve_device,
                              sub_f32)
from repro_torch.core import keys as K
from repro_torch.core import local_ops as L
from repro_torch.core import mutate as M
from repro_torch.core import queries as Q
from repro_torch.core.backends import resolve_backend
from repro_torch.core.build import LearnedSpatialIndex
from repro_torch.core.plan import (CircleQuery, DeleteBatch, EngineConfig,
                                   InsertBatch, Knn, PointQuery, QuerySpec,
                                   RangeCount, RangeQuery, Refit,
                                   SpatialJoin, UpdateSpec, exec_key)
from repro_torch.kernels import _launches as KL
from repro_torch.launch.mesh import backend_for

# partition leaf -> the index field it holds (keys_f is derived: a cast)
_LEAF_FIELDS = {"x": "x", "y": "y", "vid": "vid", "count": "count",
                "knot_keys": "knot_keys", "knot_pos": "knot_pos",
                "n_knots": "n_knots", "radix_table": "radix_table",
                "radix_kmin": "radix_kmin", "radix_scale": "radix_scale",
                "dx": "delta_x", "dy": "delta_y", "dvid": "delta_vid",
                "dcount": "delta_count"}


@dataclasses.dataclass
class _AdaptiveOp:
    """Binds one query family to the adaptive policy."""
    base: Tuple                       # sticky key
    initial: Tuple[int, int]          # starting (cap, cand)
    window: Callable                  # (cap, cand) -> local program
    get_ok: Callable                  # raw result -> ok (Q,)
    finalize: Callable                # raw result -> public result
    escalate: Callable                # (cap, cand) -> (cap, cand)
    maxed: Callable                   # (cap, cand) -> bool
    sticky_on_maxed: bool             # the reference's per-family rule
    fallback: Optional[Callable]      # (pargs, raw) -> exact result
    fused: Callable                   # (cap, cand) -> fused program
    demote: Callable                  # (cap, cand) -> lower tier
    post: Callable = lambda r: r      # fused result -> public result
    # -- the tier-bucketed dispatch (DESIGN.md §13) --------------------
    probe: Optional[Callable] = None     # cand -> need probe program
    feasible: Optional[Callable] = None  # (probe, cap, cand) -> (Q,) bool
    owidth: Optional[Callable] = None    # (cap, cand) -> vid plane width
    bucketer: Optional[Callable] = None  # (probe, cap, cand) -> (Q,) rank


def _f32_const(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor of ``v`` on ``like``'s device (how the
    reference's weakly typed Python scalars enter float32 math), filled
    on the device: no host-to-device copy on the query path."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=like.device)


def _tree(fn, *outs):
    """``fn`` over the leaves of equal output structures (a tensor, or a
    tuple of them, nested)."""
    if isinstance(outs[0], tuple):
        return tuple(_tree(fn, *leaves) for leaves in zip(*outs))
    return fn(*outs)


def _leaves(tree):
    """The tensors of a (nested) tuple, in order; None is skipped."""
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif tree is not None:
        yield tree


def _dtype_name(dtype) -> str:
    """A torch dtype in numpy's spelling ("float32", "int64", "bool")."""
    return str(dtype).removeprefix("torch.")


def _write_into(old, new):
    """``new``'s values in ``old``'s storage when shape, dtype and device
    agree (so a captured graph goes on reading the same pointer), else
    ``new`` itself."""
    if (old is None or old.shape != new.shape or old.dtype != new.dtype
            or old.device != new.device):
        return new
    if old.data_ptr() != new.data_ptr():
        old.copy_(new)
    return old


class GraphCaptureError(RuntimeError):
    """A query program could not be captured as a CUDA graph."""


# the cyclic garbage collector stays off while any capture of any
# executor is open (collecting another executor's graphs there would
# free device memory inside the capture, which invalidates it);
# gc.disable() is process-wide, so overlapping captures on two threads
# count their holds and the last one out restores the collector
_gc_lock = threading.Lock()
_gc_hold = {"captures": 0, "was_on": False}


@contextmanager
def _gc_paused():
    with _gc_lock:
        if _gc_hold["captures"] == 0:
            _gc_hold["was_on"] = gc.isenabled()
            gc.disable()
        _gc_hold["captures"] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_hold["captures"] -= 1
            if _gc_hold["captures"] == 0 and _gc_hold["was_on"]:
                gc.enable()


class _Graph:
    """One query program at one argument signature as a CUDA graph:
    static inputs, the captured launches, static outputs, the kernel
    launches the capture recorded (added to the wrappers' counts on each
    replay) and the partition planes' pointers it reads.

    All graphs of one executor allocate from one memory pool and replay
    under the executor's lock on the current stream; each call returns
    clones of the static outputs before the next replay can write them,
    so any replay order is safe."""

    __slots__ = ("key", "inputs", "graph", "outputs", "launches", "ptrs",
                 "__weakref__")

    def __init__(self, ex, key, fn, inputs, parts, bounds, stream=None):
        self.key = key
        self.inputs = inputs
        self.graph = self.outputs = None
        self.launches = {}
        self.ptrs = None
        self.capture(ex, fn, parts, bounds, stream)

    def capture(self, ex, fn, parts, bounds, stream=None) -> None:
        """Record ``fn`` on ``parts``/``bounds`` into the executor's pool:
        on ``stream`` (the precompile worker's own, current on its
        thread), or by default on the executor's capture stream, ordered
        after the current one. Raises when the program cannot be
        captured (never falls back to running it eagerly).

        Every capture of an executor runs under its capture lock, so no
        two captures into one pool or on one stream are ever open at
        once, and no graph of the executor is destroyed meanwhile
        (``Executor._retire``). The kernels' launches during the capture
        go to this thread's tally, not to the global counts: the
        capture ran none, and each replay adds them."""
        with ex._capture_lock, _gc_paused(), torch.cuda.device(ex.device):
            self.graph = self.outputs = None    # the old graph goes first
            cur = torch.cuda.current_stream()
            side = ex._capture_stream() if stream is None else stream
            if side != cur:
                side.wait_stream(cur)
            pool = ex._graph_pool()
            g = torch.cuda.CUDAGraph()
            with KL.tally() as launched:
                try:
                    with torch.cuda.stream(side):
                        g.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                        try:
                            out = fn(parts, bounds, *self.inputs)
                        except BaseException:
                            try:
                                g.capture_end()
                            except Exception:
                                pass
                            raise
                        g.capture_end()
                except Exception as e:
                    g = None        # destroyed here, under the lock
                    raise GraphCaptureError(f"CUDA graph capture of "
                                            f"{self.key} failed: {e}") from e
            if side != cur:
                cur.wait_stream(side)
            self.graph, self.outputs, self.launches = g, out, launched
            self.ptrs = _plane_ptrs(parts, bounds)
            ex._graphs.add(self)
            ex._reap()

    def __call__(self, ex, fn, args):
        if self.ptrs != _plane_ptrs(ex.parts, ex.bounds):
            # a plane was swapped, not written in place: capture again
            t0 = time.perf_counter()
            self.capture(ex, fn, ex.parts, ex.bounds)
            ex._captured((time.perf_counter() - t0) * 1e3, worker=False)
            ex.graph_recaptures += 1
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        KL.add(self.launches)
        return _tree(torch.clone, self.outputs)


def _plane_ptrs(parts, bounds) -> tuple:
    """(name, pointer, shape) of every partition plane and the boxes."""
    return tuple((k, v.data_ptr(), tuple(v.shape))
                 for k, v in sorted(parts.items())) + \
        (("bounds", bounds.data_ptr(), tuple(bounds.shape)),)


# the executor whose precompile worker runs on this thread
_PC_THREAD = threading.local()


class _Dispatch:
    """Per-exec_key dispatcher (DESIGN.md §14): one local program,
    realized once per argument SIGNATURE, the (shape, dtype) of every
    argument after ``prefix`` (dtypes in numpy's spelling).

    ``prefix`` 2: a query program, called as fn(parts, bounds, *q) (the
    index state is keyed by shape epoch, not in the signature); 0: an
    update program on raw arguments. On the card a query program is
    realized as a CUDA graph (``_Graph``): the first call at a signature
    runs the program eagerly and captures nothing (so every first-use
    set-up of its launchers happens outside a capture); the second
    copies its arguments into static inputs, captures the program on
    them and replays it (that call's result); each later call copies
    in, replays and returns clones of the outputs. While the executor's
    precompile worker runs, the second call captures nothing on the
    calling thread: it hands the capture to the worker and runs eagerly
    until the worker installs the graph. Update programs, programs that
    read the host (``host_reads``) and calls with an empty argument run
    eagerly; on the CPU every realization is the program itself.
    ``compile_ms_total`` counts capture time."""

    __slots__ = ("ex", "key", "fn", "prefix", "_fns")

    def __init__(self, ex, key, fn, prefix: int):
        self.ex = ex
        self.key = key
        self.fn = fn
        self.prefix = prefix
        self._fns = {}            # signature -> _Graph, or fn (eager)

    @staticmethod
    def sig_of(args) -> Tuple:
        return tuple((tuple(int(d) for d in a.shape), _dtype_name(a.dtype))
                     for a in _leaves(args))

    def sigs(self) -> list:
        """Signatures realized so far (manifest recording)."""
        return sorted(self._fns)

    def _graphed(self, sig) -> bool:
        return (self.ex.cuda_graphs and self.prefix == 2
                and not self.fn.host_reads
                and all(math.prod(s) > 0 for s, _ in sig))

    def warmed(self, sig) -> bool:
        """Whether a call at ``sig`` runs a finished realization: its
        CUDA graph where the signature is graphed, else the program."""
        real = self._fns.get(sig)
        if isinstance(real, _Graph):
            return True
        return real is not None and not self._graphed(sig)

    def _capture(self, sig, inputs) -> None:
        ex = self.ex
        t0 = time.perf_counter()
        self._fns[sig] = _Graph(ex, self.key, self.fn, inputs, ex.parts,
                                ex.bounds)
        ex._captured((time.perf_counter() - t0) * 1e3, worker=False)

    def __call__(self, *args):
        q = args[self.prefix:]
        sig = self.sig_of(q)
        real = self._fns.get(sig)
        if isinstance(real, _Graph):
            return real(self.ex, self.fn, q)
        if real is not None and self._graphed(sig):
            if self.ex.precompiling:
                # the worker captures; this call stays eager
                self.ex._pc_capture(self, sig)
                return self.fn(*args)
            # the signature's second call: capture, then replay
            inputs = tuple(torch.empty_like(a) for a in q)
            self._capture(sig, inputs)
            return self._fns[sig](self.ex, self.fn, q)
        self._fns[sig] = self.fn
        return self.fn(*args)

    def warm(self, sig: Tuple) -> bool:
        """Realize one signature without a query: on the card, capture
        its CUDA graph from zero-filled inputs (after one eager run on
        them, so every first-use set-up happens before the capture),
        also where the signature already ran eagerly. On the precompile
        worker's thread the capture runs there (``Executor._warm_async``).
        Returns True when work actually happened."""
        sig = tuple((tuple(int(d) for d in s), str(d)) for s, d in sig)
        ex = self.ex
        if ex._on_worker():
            return ex._warm_async(self, sig)
        if self.warmed(sig):
            return False
        if not self._graphed(sig):
            self._fns[sig] = self.fn
            return True
        inputs = tuple(torch.zeros(s, dtype=getattr(torch, d),
                                   device=ex.device) for s, d in sig)
        self.fn(ex.parts, ex.bounds, *inputs)
        self._capture(sig, inputs)
        return True

    def drop(self) -> None:
        """Drop every realization (an evicted key frees its graphs, once
        no capture of the executor is open)."""
        dead = list(self._fns.values())
        self._fns.clear()
        self.ex._retire(dead)


class _Meshed:
    """A local program bound to a mesh: on the partition axis ``axis``
    (``launch/mesh.Axis``), and with ``qaxis`` also sharded over the
    query axis: the query arguments are padded to a multiple of its size
    by repeating row 0 (a real query, so padding trips no ok flag), this
    rank runs its contiguous row block (``P(query_axis)``), and every
    output (leading axis: the query batch) is gathered over the query
    axis in order and un-padded. Every rank of the mesh returns the
    whole result."""

    def __init__(self, fn, axis, qaxis=None):
        self.fn = fn
        self.axis = axis
        self.qaxis = qaxis
        self.host_reads = fn.host_reads
        self.n_query_args = fn.n_query_args

    def __call__(self, parts, bounds, *q):
        if self.qaxis is None:
            return self.fn(parts, bounds, *q, axis=self.axis)
        qsize = self.qaxis.size
        qlen = q[0].shape[0]
        pad = (-qlen) % qsize
        if pad:
            q = _pad_rows(q, pad)
        rows = (qlen + pad) // qsize
        lo = self.qaxis.index * rows
        out = self.fn(parts, bounds, *(a[lo:lo + rows] for a in q),
                      axis=self.axis)
        out = _tree(self.qaxis.all_gather0, out)
        return _tree(lambda a: a[:qlen], out) if pad else out


def _pad_rows(args, n: int):
    """Each (rows, ...) tensor of ``args`` with its row 0 repeated ``n``
    more times at the end (a real query, so the padding runs the same
    program)."""
    return tuple(torch.cat([a, a[:1].expand((n,) + tuple(a.shape[1:]))])
                 for a in args)


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class Executor:
    """Runs QuerySpecs against ``index`` on ``device`` (default: the
    card; "cpu" to run on the CPU). The index is padded to a multiple of
    ``config.part_chunk`` partitions and moved to the device.

    ``mesh`` (``launch/mesh.make_host_mesh``; default None, one device)
    shards the partitions over ``part_axis`` (a name or a tuple of
    names) and, with ``query_axis``, large query batches over that axis
    (module docstring). Every rank constructs its executor with the same
    arguments; ``device`` is this rank's (NCCL on the card, gloo on the
    CPU). With a mesh, ``index`` is the whole index, or this rank's
    shard of it (``part_total`` set: ``convert.load_index(...,
    mesh=mesh)``), which must be the rows this rank would cut.

    ``cuda_graphs`` (True on the card) realizes query programs as CUDA
    graphs; set it False before the first call to run them eagerly. With
    graphs on, the executor holds its own copy of the partition planes,
    which updates write in place; without, updates swap them. Meshed
    programs are captured too, their collectives with them."""

    def __init__(self, index: LearnedSpatialIndex,
                 config: Optional[EngineConfig] = None, device="cuda",
                 mesh=None, part_axis="data", query_axis=None):
        self.device = resolve_device(device)
        self.cfg = config if config is not None else EngineConfig()
        self.backend = resolve_backend(self.cfg.backend, self.device)
        self.mesh = mesh
        self.part_axis = part_axis
        self.query_axis = query_axis
        if query_axis is not None:
            if mesh is None:
                raise ValueError("query_axis requires a mesh")
            bad = set(_axes(query_axis)) & set(_axes(part_axis))
            if bad:
                raise ValueError(
                    f"query_axis overlaps part_axis: {sorted(bad)}")
        self._axis = self._qaxis = None
        if mesh is None:
            index = L.pad_partitions(index.to(self.device),
                                     self.cfg.part_chunk)
            self.p_total = index.num_partitions
        else:
            self._axis = mesh.axis(_axes(part_axis))
            if query_axis is not None:
                self._qaxis = mesh.axis(_axes(query_axis))
            self._check_groups()
            shards = self._axis.size
            if index.part_total:
                # this rank's shard, cut before it was loaded
                # (convert.load_index): ids come from every rank's rows
                p_loc, self.p_total = index.num_partitions, index.part_total
                if (p_loc * shards != self.p_total
                        or p_loc % self.cfg.part_chunk
                        or index.part_offset != self._axis.offset(p_loc)):
                    raise ValueError(
                        f"shard rows [{index.part_offset}, "
                        f"{index.part_offset + p_loc}) of {self.p_total} "
                        f"are not this rank's of {shards} shards of "
                        f"part_chunk {self.cfg.part_chunk}")
                nxt0 = self._axis.agree([self._max_vid(index)])[0]
                index = index.to(self.device)
            else:
                index = L.pad_partitions(index,
                                         shards * self.cfg.part_chunk)
                self.p_total = index.num_partitions
                p_loc = self.p_total // shards
                # every rank sees the whole index; ids come from all of it
                nxt0 = self._max_vid(index)
                index = L.shard_partitions(index, self._axis.offset(p_loc),
                                           p_loc).to(self.device)
        self.cuda_graphs = self.device.type == "cuda"
        # a graph reads fixed pointers: own the planes, write them in place
        own = self.cuda_graphs
        self.parts = {k: v.clone() if own and k in _LEAF_FIELDS else v
                      for k, v in L.part_arrays(index).items()}
        self.bounds = index.part_bounds.clone() if own else \
            index.part_bounds                           # (P, 4)
        self.index = self._bind(index, self.parts)
        self.spec = index.key_spec
        b = index.key_spec.bounds
        self.area = max((b[2] - b[0]) * (b[3] - b[1]), 1e-30)
        self._recount()
        # -- mutable-index state (DESIGN.md §11) -------------------------
        self.next_vid = (nxt0 if mesh is not None
                         else self._max_vid(index)) + 1
        self._refit_pending = set()  # partition ids awaiting compaction
        self.updates = 0      # applied insert/delete batches
        self.refits = 0       # refit_partitions invocations
        self._sticky = {}     # sticky_key -> last successful (cap, cand)
        self._initial = {}    # sticky_key -> initial (cap, cand), as the
                              # reference keeps it
        self._pending = {}    # sticky_key -> (tier, ok device tensor)
        self._escalators = {}  # sticky_key -> the op's escalate rule
        self._demoters = {}   # sticky_key -> the op's demote rule
        self._ok_streak = {}  # sticky_key -> consecutive clean checks
        self._demoted_from = {}   # sticky_key -> tier last demoted FROM
        self._demote_backoff = {}  # sticky_key -> streak multiplier
        self.host_syncs = 0   # counted host reads of ok (_all_ok)
        self.probe_syncs = 0  # host reads of a bucketed call's sizes
        self.dispatches = 0   # local-program and update-program calls
        # -- the program cache (DESIGN.md §14) ----------------------------
        self._cache = {}      # exec_key -> _Dispatch
        self.compile_ms_total = 0.0  # wall spent capturing CUDA graphs
        # the same wall by the thread that captured: the serving side's
        # (the caller of run) and the precompile worker's
        self.capture_ms = {"serving": 0.0, "worker": 0.0}
        self.graph_recaptures = 0    # captures redone: a plane moved
        self._pool = None     # the graphs' shared memory pool
        self._stream = None   # the side stream graphs are captured on
        # every capture of this executor, on any thread, holds this lock
        # (ordered after self._lock: a thread holding it never waits on
        # self._lock), and so does every destruction of its graphs
        self._capture_lock = threading.RLock()
        self._graphs = weakref.WeakSet()  # live _Graphs (they hold the pool)
        self._graveyard = []  # dropped _Graphs awaiting the capture lock
        # -- the precompile worker (DESIGN.md §14, async precompilation) -
        self.async_compiles = 0      # realizations done by the worker
        self.async_capture_errors = 0  # its captures that raised
        self._pc_thread = None
        self._pc_stop = None
        self._pc_q = None
        self._pc_seen = set()
        self._pc_done = set()
        self._pc_stream = None  # the worker's own stream (on the card)
        self._serve_stream = None  # the stream of the thread that last
                                   # handed the worker a job
        self._disk = None     # the on-disk kernel-library store
        if self.cfg.compile_cache_dir:
            from repro_torch.core.compile_cache import (CompileCache,
                                                        process_context)
            from repro_torch.kernels import _build
            self._disk = CompileCache(self.cfg.compile_cache_dir,
                                      self.cfg.compile_cache_bytes,
                                      context=process_context(self.device))
            _build.use_store(self._disk)
        # serializes run, maintain and refit, so several threads can
        # share one executor (sticky state, stashed ok flags, the index);
        # reentrant because run(Refit) and maintain() call refit()
        self._lock = threading.RLock()

    @staticmethod
    def _max_vid(index) -> int:
        nxt = int(index.vid.max())
        if index.delta_vid is not None and index.delta_cap:
            nxt = max(nxt, int(index.delta_vid.max()))
        return nxt

    def _check_groups(self) -> None:
        """The mesh's groups run this device's backend (NCCL on the card,
        gloo on the CPU; never another), and each issues one collective
        now, so its communicator exists before any CUDA graph capture."""
        import torch.distributed as dist
        want = backend_for(self.device)
        for ax in (self._axis, self._qaxis):
            if ax is None:
                continue
            got = str(dist.get_backend(ax.group))
            if got != want or ax.device != self.device:
                raise ValueError(f"a mesh on {ax.device} with backend "
                                 f"{got} cannot serve an executor on "
                                 f"{self.device} (needs {want})")
            ax.agree([0])

    def _part_shards(self) -> int:
        """Partition shards (1 without a mesh)."""
        return 1 if self._axis is None else self._axis.size

    def _agree(self, values, op: str = "max") -> list:
        """Host integers agreed over the partition axis (``op`` "max" or
        "sum"); on one device, the values."""
        values = [int(v) for v in values]
        return values if self._axis is None else self._axis.agree(values, op)

    def _shard_rows(self, pids):
        """(local rows, mine) of global partition ids (numpy ints): each
        id's row on this rank, clamped, and whether this rank holds it
        (every id, without a mesh)."""
        pids = torch.as_tensor(np.asarray(pids, np.int64))
        local, mine = L._local(pids, torch.ones_like(pids, dtype=torch.bool),
                               self._axis, self.index.num_partitions)
        return local.numpy(), mine.numpy()

    def _f32(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _i32(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.int32).contiguous()
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _call(self, fn, *args):
        self.dispatches += 1
        return fn(self.parts, self.bounds, *args)

    # -- the program cache (DESIGN.md §14) --------------------------------

    def _key(self, base, tag="x", variant=None, qshard=False):
        """Canonical cache key (plan.exec_key): backend, query-shard and
        shape-epoch aware (a program bakes the index's static shapes;
        superseded shape epochs are swept by _evict_stale)."""
        return exec_key(self.backend.name, base, tag, variant,
                        qshard=qshard, epoch=self.index.shape_epoch)

    def _use_qshard(self, qlen: int) -> bool:
        """Shard this batch over the query axis? (DESIGN.md §10)"""
        return (self._qaxis is not None
                and qlen >= self.cfg.query_shard_threshold)

    def _compile(self, key, make_fn):
        """The cached dispatcher of ``key``, building its local program
        with ``make_fn`` on a miss. On a mesh the program is bound to the
        partition axis, and for a query-sharded key (``key[1]``) wrapped
        to shard its queries over the query axis (``_Meshed``)."""
        disp = self._cache.get(key)
        if disp is None:
            fn = make_fn()
            if self.mesh is not None:
                fn = _Meshed(fn, self._axis, self._qaxis if key[1] else None)
            disp = self._cache[key] = _Dispatch(self, key, fn, prefix=2)
        return disp

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _graph_pool(self):
        """The memory pool every graph of this executor shares (capture
        lock held). A pool lives while a graph holds it: once the last
        one is gone (evicted, or a capture failed), the next capture
        opens a new pool."""
        if self._pool is None or not any(
                g.graph is not None for g in list(self._graphs)):
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _captured(self, ms: float, worker: bool) -> None:
        self.compile_ms_total += ms
        self.capture_ms["worker" if worker else "serving"] += ms

    def _retire(self, dead: list) -> None:
        """Destroy the _Graphs of ``dead`` (a list it empties) where no
        capture of this executor is open: at once when the capture lock
        is free, else when the open capture closes (``_reap``). So a
        drop, an eviction or a release never frees graph memory, or
        decides the pool is unused, under the worker's open capture."""
        self._graveyard.extend(r for r in dead if isinstance(r, _Graph))
        dead.clear()
        if self._capture_lock.acquire(blocking=False):
            try:
                self._reap()
            finally:
                self._capture_lock.release()

    def _reap(self) -> None:
        """Destroy the retired graphs (capture lock held)."""
        while self._graveyard:
            self._graveyard.pop()

    def _drop(self, key) -> None:
        self._cache.pop(key).drop()

    def release(self) -> None:
        """Drop every cached program with its CUDA graphs and give their
        memory pool back to the card. The next call at each signature
        realizes its program again (eager first, captured second);
        sticky tiers and the index stay. Waits for an open capture of
        the precompile worker to close before it empties the
        allocator's cache; a graph the worker captured meanwhile is not
        installed."""
        with self._lock:
            for key in list(self._cache):
                self._drop(key)
            with self._capture_lock:
                self._reap()
                self._pool = None
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()

    def _evict(self, base):
        """Drop superseded cap-variants: keep the sticky and initial
        tiers, so escalation cannot leak one program (and its graphs)
        per step in long-running serving.

        FUSED programs additionally keep every ladder tier between the
        initial and sticky tiers (O(log) of them), the tier above sticky
        and the demotion target: the bucketed dispatch (DESIGN.md §13)
        runs light buckets at below-sticky tiers on every batch. Probe
        ("p") programs are tier-independent and only swept by shape
        epoch (_evict_stale)."""
        sticky = self._sticky.get(base)
        initial = self._initial.get(base)
        keep_w = {sticky, initial}
        keep_f = set(keep_w)
        esc = self._escalators.get(base)
        dem = self._demoters.get(base)
        if sticky is not None:
            if esc is not None:
                keep_f.add(esc(*sticky))
            if dem is not None:
                keep_f.add(dem(*sticky))
        if esc is not None and sticky is not None and initial is not None:
            cur = initial
            for _ in range(64):          # ladders are O(log) long
                keep_f.add(cur)
                if cur == sticky:
                    break
                nxt = esc(*cur)
                if nxt == cur:
                    break
                cur = nxt
        for key in list(self._cache):
            if key[2] != tuple(base):
                continue
            if ((key[3] == "w" and key[4] not in keep_w) or
                    (key[3] == "fused" and key[4] not in keep_f)):
                self._drop(key)

    def _evict_stale(self):
        """Drop the programs of a superseded index shape epoch (a delta
        capacity growth, an n_pad or knot widening, a probe refresh)."""
        cur = self.index.shape_epoch
        for key in list(self._cache):
            if key[5] != cur:
                self._drop(key)

    def cache_variants(self, base) -> list:
        """Cached (tag, (cap, cand)) window variants for one sticky key."""
        return sorted((k[3], k[4]) for k in self._cache
                      if k[2] == tuple(base) and k[3] in ("w", "fused"))

    def cache_keys(self) -> list:
        """All program-cache keys (plan.exec_key layout)."""
        return list(self._cache)

    # -- manifest-driven prewarm (DESIGN.md §14) -------------------------

    def _op_for(self, base) -> Optional[_AdaptiveOp]:
        """The adaptive-op descriptor of a sticky base: what lets a
        recorded manifest rebuild any program family from its key."""
        kind = base[0]
        if kind == "range":
            return self._op_range(tuple(base))
        if kind == "circle":
            return self._op_circle(tuple(base), bool(base[1]))
        if kind == "knn":
            return self._op_knn(tuple(base), int(base[1]))
        if kind == "join":
            return self._op_join(tuple(base))
        return None

    def _factory_for(self, base, tag, variant):
        idx, cfg, bk = self.index, self.cfg, self.backend
        kind = base[0]
        if tag == "u":
            return {"insert": (lambda: M.scatter_inserts),
                    "delete": (lambda: M.apply_deletes)}.get(kind)
        if tag == "x":
            if kind == "point":
                return lambda: L._PointLocal(idx, cfg, bk)
            if kind == "range_count":
                return lambda: L._RangeCountLocal(idx, cfg, bk)
            if kind == "circle_exact":
                return lambda: L._CircleCountLocal(idx, cfg, bk)
            if kind == "join_full":
                return lambda: L._JoinFullLocal(idx, cfg, bk)
            if kind == "knn_exact":
                return lambda: L._KnnExactLocal(idx, cfg, bk, int(base[1]))
            return None
        op = self._op_for(base)
        if op is None:
            return None
        if tag == "p" and op.probe is not None:
            return lambda: op.probe(int(variant[0]))
        if tag == "w":
            return lambda: op.window(*variant)
        if tag == "fused":
            return lambda: op.fused(*variant)
        return None

    def manifest(self) -> dict:
        """JSON-serializable snapshot of everything realized and tuned:
        sticky tiers, delta capacity, and every realized (exec_key,
        signature). Replay it with ``prewarm()``, in this process after
        an eviction or in a later one (compile_cache.save_manifest /
        load_manifest round-trip it through JSON)."""
        with self._lock:
            progs = []
            for key, v in sorted(self._cache.items(), key=repr):
                if not v.sigs() or key[5] != self.index.shape_epoch:
                    continue
                variant = (list(key[4]) if isinstance(key[4], tuple)
                           else key[4])
                progs.append({
                    "key": [key[0], bool(key[1]), list(key[2]),
                            key[3], variant],
                    "sigs": [[[list(s), d] for s, d in sig]
                             for sig in v.sigs()],
                })
            return {"version": 1,
                    "backend": self.backend.name,
                    "delta_cap": int(self.index.delta_cap or 0),
                    "sticky": [[list(b), list(t)]
                               for b, t in sorted(self._sticky.items())],
                    "programs": progs}

    def prewarm(self, manifest: dict, exercise: bool = False) -> dict:
        """Replay a recorded manifest: install the recorded delta
        capacity FIRST (so the shape-epoch bump cannot evict what is
        about to be realized), preset the sticky tiers, then realize
        every recorded (program, signature) without running a query
        (on the card: capture its CUDA graph from zero-filled inputs).
        ``exercise=True`` also routes one zero-filled query batch per
        recorded READ family through the public ``run`` path, outputs
        discarded and adaptive bookkeeping restored, to absorb the
        first-use cost of the host-side preparation
        (``_exercise_families``); update programs are never run.
        Returns {programs, compiled, skipped} counts."""
        if not isinstance(manifest, dict) or \
                manifest.get("version") != 1:
            return {"programs": 0, "compiled": 0, "skipped": 0}
        with self._lock:
            return self._prewarm_locked(manifest, exercise)

    def _prewarm_locked(self, manifest: dict, exercise: bool = False
                        ) -> dict:
        progs = [p for p in manifest.get("programs", ())
                 if p["key"][0] == self.backend.name]
        # 1. delta capacity before ANY realization: the recorded cap is
        # already pow2-at-least(cfg floor), so this reproduces the shape
        # a first insert would install
        dcap = int(manifest.get("delta_cap") or 0)
        has_u = any(p["key"][3] == "u" for p in progs)
        if dcap > 0 or has_u:
            idx = self.index
            need = max(dcap, 1)
            if idx.delta_count is None or idx.delta_cap < need:
                self._install_index(M.with_delta_capacity(
                    idx, need, floor=self.cfg.delta_cap))
        # 2. sticky tiers, so live traffic dispatches fused programs at
        # the recorded tier from the first request
        for b, t in manifest.get("sticky", ()):
            self._sticky[tuple(b)] = tuple(int(v) for v in t)
        # 3. realize the programs
        compiled = skipped = 0
        for p in progs:
            _bk, qs, base, tag, variant = p["key"]
            base = tuple(base)
            if isinstance(variant, list):
                variant = tuple(int(v) for v in variant)
            if qs and self._qaxis is None:
                skipped += 1        # a query-sharded wrapping needs a
                continue            # query axis
            if tag == "u" and variant and \
                    int(variant[1]) != int(self.index.delta_cap or 0):
                skipped += 1        # stale capacity variant
                continue
            make_fn = self._factory_for(base, tag, variant)
            if make_fn is None:
                skipped += 1
                continue
            key = self._key(base, tag, variant, qshard=bool(qs))
            if tag == "u":
                if key not in self._cache:
                    self._cache[key] = _Dispatch(self, key, make_fn(),
                                                 prefix=0)
                disp = self._cache[key]
            else:
                disp = self._compile(key, make_fn)
            for sig in p.get("sigs", ()):
                sig_t = tuple((tuple(int(d) for d in s), str(dt))
                              for s, dt in sig)
                compiled += bool(disp.warm(sig_t))
        if exercise:
            self._exercise_families(progs)
        return {"programs": len(progs), "compiled": compiled,
                "skipped": skipped}

    def _exercise_families(self, progs) -> None:
        """Real ``run()`` calls per recorded read family, on zero-filled
        queries at each recorded narrow batch width, outputs discarded.

        Realizing the programs is not enough after a restart: the host
        side of each dispatch (the key encodes, the kNN radius estimate,
        the polygon MBRs) pays its first-use cost in a fresh process,
        per batch shape, so every recorded narrow width is exercised.
        Widths at or above ``tier_bucket_min`` are skipped: they take
        the data-dependent bucketed dispatch, whose zero-query buckets
        could realize widths the recorded traffic never used. Adaptive
        bookkeeping is snapshotted and restored, so prewarm never
        changes what later traffic computes; update programs never
        run."""
        fam = {}
        bmin = self.cfg.tier_bucket_min
        for p in progs:
            _bk, qs, base, tag, _variant = p["key"]
            base = tuple(base)
            want = "x" if base[0] in ("point", "range_count",
                                      "knn_exact", "join_full") \
                else "fused"
            if tag != want:
                continue        # a width's dispatch picks its wrapping
            for sig in p.get("sigs", ()):
                if sig[0][0][0] < bmin:
                    fam.setdefault(base, {})[tuple(sig[0][0])] = sig
        pending = dict(self._pending)
        for base, sigs in sorted(fam.items(), key=repr):
            for sig in sigs.values():
                self._exercise_one(base, sig)
        if self.device.type == "cuda":
            with self._capture_lock:    # a device-wide wait: never
                torch.cuda.synchronize(self.device)  # inside a capture
        self._pending = pending

    def _exercise_one(self, base, sig) -> None:
        b = int(sig[0][0][0])
        kind = base[0]
        f32 = np.float32
        try:
            if kind == "point":
                req = (PointQuery(), np.zeros(b, f32), np.zeros(b, f32))
            elif kind == "range_count":
                req = (RangeCount(), np.zeros((b, 4), f32))
            elif kind == "range":
                req = (RangeQuery(), np.zeros((b, 4), f32))
            elif kind == "circle":
                req = (CircleQuery(materialize=bool(base[1])),
                       np.zeros(b, f32), np.zeros(b, f32),
                       np.zeros(b, f32))
            elif kind == "knn":
                req = (Knn(k=int(base[1])), np.zeros(b, f32),
                       np.zeros(b, f32))
            elif kind == "knn_exact":
                req = (Knn(k=int(base[1]), mode="exact"),
                       np.zeros(b, f32), np.zeros(b, f32))
            elif kind in ("join", "join_full"):
                v = int(sig[0][0][1])
                req = (SpatialJoin(mode="full" if kind ==
                                   "join_full" else "windowed"),
                       np.zeros((b, v, 2), f32),
                       np.full(b, min(3, v), np.int32))
            else:
                return
            self.run(req[0], *req[1:])
        except GraphCaptureError:
            raise                       # a program that cannot be graphed
        except Exception:
            pass                        # best-effort, like the reference

    def _all_ok(self, ok) -> bool:
        """The only counted host read of ``ok`` on the query path."""
        self.host_syncs += 1
        return bool(ok.all())

    # -- public entry points ---------------------------------------------

    def run(self, spec: QuerySpec, *args, strict: bool = False):
        """Execute one QuerySpec. ``strict=True`` runs the adaptive specs'
        host-checked escalation loop; ``strict=False`` runs serving mode
        once the family has a sticky tier (module docstring).
        Thread-safe."""
        if not isinstance(spec, QuerySpec):
            raise TypeError(f"expected a QuerySpec, got {spec!r}")
        if len(args) != spec.n_args:
            raise TypeError(f"{type(spec).__name__} takes {spec.n_args} "
                            f"data arguments, got {len(args)}")
        with self._lock:
            if isinstance(spec, InsertBatch):
                return self._run_insert(args)
            if isinstance(spec, DeleteBatch):
                return self._run_delete(args)
            if isinstance(spec, Refit):
                return self.refit()
            if isinstance(spec, PointQuery):
                return self._run_point(args)
            if isinstance(spec, RangeCount):
                return self._run_range_count(args)
            if isinstance(spec, RangeQuery):
                return self._run_range(spec, args, strict)
            if isinstance(spec, CircleQuery):
                return self._run_circle(spec, args, strict)
            if isinstance(spec, Knn):
                return self._run_knn(spec, args, strict)
            if isinstance(spec, SpatialJoin):
                return self._run_join(spec, args, strict)
        raise TypeError(f"unknown QuerySpec: {spec!r}")

    def run_batch(self, requests, strict: bool = False) -> list:
        """Execute (spec, *args) tuples; results in request order. A
        steady batch (every adaptive family on a sticky tier) makes no
        host sync."""
        return [self.run(req[0], *req[1:], strict=strict)
                for req in requests]

    def run_rows(self, spec: QuerySpec, *args, rows: int):
        """``run(spec, *args)`` in serving mode as consecutive calls on
        ``rows``-row slices of the batch (tensors), the last slice
        padded with its own row 0 (a real query) and trimmed, outputs
        concatenated: bitwise one call, because each output row depends
        only on its row and the tier (as ``_fused_chunked`` relies on).
        The serve scheduler runs a batch this way at a width whose CUDA
        graphs are captured. The ok flags the slices stash are merged,
        so ``maintain()`` sees the whole batch's. An adaptive family
        with no sticky tier yet runs as one call (its strict loop could
        settle a tier per slice). Thread-safe."""
        if isinstance(spec, UpdateSpec):
            raise TypeError("run_rows serves queries, not updates")
        base = spec.sticky_key()
        with self._lock:
            n = int(args[0].shape[0])
            adaptive = not isinstance(spec, (PointQuery, RangeCount)) and \
                getattr(spec, "mode", "windowed") not in ("exact", "full")
            if rows >= n or (adaptive and base not in self._sticky):
                return self.run(spec, *args)
            outs, oks = [], []
            for s in range(0, n, rows):
                part = tuple(a[s:s + rows] for a in args)
                tail = rows - int(part[0].shape[0])
                if tail:
                    part = _pad_rows(part, tail)
                self._pending.pop(base, None)
                out = self.run(spec, *part)
                outs.append(_tree(lambda a: a[:rows - tail], out)
                            if tail else out)
                if base in self._pending:
                    oks.append(self._pending[base])
            if oks and all(t == oks[0][0] for t, _ in oks):
                self._pending[base] = (oks[0][0],
                                       torch.cat([ok for _, ok in oks]))
            return _tree(lambda *a: torch.cat(a), *outs)

    def maintain(self) -> dict:
        """Deferred re-tuning, off the serving hot path: read the ok
        flags that serving calls stashed; escalate a sticky tier that
        overflowed, and demote one that stayed clean for
        ``EngineConfig.demote_after`` consecutive checks. A demotion
        that the next overflow undoes (the escalation lands on the tier
        it left) doubles that family's required clean streak. Counts
        stay exact either way: an overflowed serving call already took
        the exact fallback on the device. Then the deferred compaction:
        the partitions whose delta occupancy an update pushed past
        ``EngineConfig.delta_occupancy`` are re-fit (reported under
        "refit"). Returns {sticky_key: new (cap, cand)} for the tiers
        that moved. Thread-safe."""
        with self._lock:
            return self._maintain_locked()

    def _maintain_locked(self) -> dict:
        moved = {}
        for base, (tier, ok) in list(self._pending.items()):
            del self._pending[base]
            if self._sticky.get(base) != tier:
                continue   # stale: the sticky tier moved since the stash
            if self._all_ok(ok):
                streak = self._ok_streak.get(base, 0) + 1
                self._ok_streak[base] = streak
                # the demoted tier survived a clean check: a real
                # demotion, so a later escalation through it is no bounce
                self._demoted_from.pop(base, None)
                need = (self.cfg.demote_after *
                        self._demote_backoff.get(base, 1))
                if streak < need:
                    continue
                new = self._demoters[base](*tier)
                if new != tier:
                    self._demoted_from[base] = tier
                    self._set_sticky(base, new)
                    moved[base] = new
                continue
            self._ok_streak[base] = 0
            new = self._escalators[base](*tier)
            if new != tier:
                if self._demoted_from.pop(base, None) == new:
                    # immediate bounce: back off, never veto for good
                    self._demote_backoff[base] = \
                        self._demote_backoff.get(base, 1) * 2
                self._set_sticky(base, new)
                moved[base] = new
        # deferred compaction + re-fit, scheduled by updates whose delta
        # occupancy crossed the threshold, run here off the hot path
        if self._refit_pending:
            done = self.refit(sorted(self._refit_pending))
            if done:
                moved["refit"] = done
        return moved

    def stats(self) -> dict:
        """Counters: host_syncs, probe_syncs, dispatches, cache_size (the
        cached programs), backend, qshard_executables (the cached
        query-axis wrappings), compile_ms_total (capture time),
        disk_cache_hits and disk_cache_misses (the kernel-library store's,
        process-level; 0 without a cache directory), async_compiles (the
        precompile worker's realizations: CUDA graphs on the card),
        sticky tiers, the index's epoch and shape_epoch, applied updates
        and re-fits, and the partitions with a re-fit pending: the
        reference's 16 keys. One more, async_capture_errors, counts the
        worker's captures that raised (the reference has no captures);
        a serving run never sees them, it stays eager at that
        signature."""
        hits = misses = 0
        if self._disk is not None:
            from repro_torch.kernels import _build
            hits, misses = _build.disk_hits, _build.disk_misses
        return {"host_syncs": self.host_syncs,
                "probe_syncs": self.probe_syncs,
                "dispatches": self.dispatches,
                "cache_size": len(self._cache),
                "backend": self.backend.name,
                "qshard_executables": sum(1 for k in self._cache if k[1]),
                "compile_ms_total": round(self.compile_ms_total, 1),
                "disk_cache_hits": hits,
                "disk_cache_misses": misses,
                "async_compiles": self.async_compiles,
                "sticky": dict(self._sticky),
                "epoch": self.index.epoch,
                "shape_epoch": self.index.shape_epoch,
                "updates": self.updates,
                "refits": self.refits,
                "pending_refit": sorted(self._refit_pending),
                "async_capture_errors": self.async_capture_errors}

    @property
    def epoch(self) -> int:
        """Mutation epoch of the resident index: a read dispatched after
        a write sees an epoch at least the write's."""
        return self.index.epoch

    def maintenance_due(self) -> bool:
        """Deferred maintain() work waiting: stashed ok flags of serving
        calls, or occupancy-scheduled re-fits."""
        return bool(self._pending) or bool(self._refit_pending)

    # -- the precompile worker (DESIGN.md §14, async precompilation) ----

    @property
    def precompiling(self) -> bool:
        """Whether the precompile worker is running. The serve scheduler
        reads it to decide its batch width."""
        return self._pc_thread is not None

    def start_precompiler(self) -> bool:
        """Start the background thread that realizes the predictable
        next programs off the serving thread: the escalation tier above
        sticky and the demotion target after a sticky move, each (spec,
        width) the serve scheduler hands over, and each signature met
        for the second time. On the card a realization is a CUDA graph
        capture, on the worker's own stream, under the capture lock;
        meanwhile no capture runs on the serving thread. While it runs,
        a device-wide ``torch.cuda.synchronize()`` fails during its
        captures: callers wait on events or streams, or quiesce first.
        Idempotent: returns True when a thread was actually started.
        Refused (ValueError) on a mesh of more than one rank: which
        programs it captures, and when, follows thread timing, so the
        ranks' collectives would not meet in one order."""
        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError("the precompile worker cannot run on a mesh "
                             f"of {self.mesh.size} ranks: its captures "
                             "follow thread timing, which differs from "
                             "rank to rank, so their collectives would not "
                             "meet")
        if self._pc_thread is not None:
            return False
        import queue
        self._pc_q = queue.Queue()
        self._pc_stop = threading.Event()
        t = threading.Thread(target=self._pc_loop, daemon=True,
                             name="executor-precompile")
        self._pc_thread = t
        t.start()
        return True

    def stop_precompiler(self) -> None:
        """Stop the worker and join it: a capture it has open finishes
        first (and installs only if its program is still cached). Jobs
        still queued are dropped."""
        if self._pc_thread is None:
            return
        self._pc_stop.set()
        self._pc_q.put(None)
        self._pc_thread.join(timeout=60)
        self._pc_thread = None
        self._pc_seen = set()

    def _on_worker(self) -> bool:
        return getattr(_PC_THREAD, "ex", None) is self

    def _pc_submit(self, label, thunk):
        if self._pc_thread is None or label in self._pc_seen:
            return None
        if self.device.type == "cuda":
            # the worker's device work is ordered after what this
            # thread queued so far (the planes it reads)
            self._serve_stream = torch.cuda.current_stream(self.device)
        self._pc_seen.add(label)
        self._pc_q.put((label, thunk))
        return label

    def precompile_done(self, label) -> bool:
        """Has a precompile job (by the label ``precompile_async``
        returned) finished?"""
        return label in self._pc_done

    def precompile_quiesce(self, timeout: float = 60.0) -> bool:
        """Block until every enqueued precompile job has finished (or
        the timeout passes; returns False then)."""
        if self._pc_thread is None:
            return True
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if all(lbl in self._pc_done for lbl in tuple(self._pc_seen)):
                return True
            time.sleep(0.002)
        return False

    def _pc_loop(self):
        _PC_THREAD.ex = self
        while not self._pc_stop.is_set():
            item = self._pc_q.get()
            if item is None or self._pc_stop.is_set():
                break
            label, thunk = item
            try:
                # the job captures OUTSIDE the executor lock (it takes it
                # briefly to find its programs and to install a graph);
                # a failed speculative job never takes serving down
                self.async_compiles += int(thunk() or 0)
            except GraphCaptureError:
                self.async_capture_errors += 1
            except Exception:
                pass
            self._pc_done.add(label)

    def precompile_async(self, spec: QuerySpec, *args):
        """Feed one predicted next (spec, argument shapes) to the worker,
        which realizes exactly the programs the steady path would run at
        those shapes (``_warm_targets``: only the arguments' shapes and
        dtypes are read, so a zero-stride array will do). It runs no
        query, so results are unaffected; only WHERE the capture happens
        moves. Returns a label to poll with ``precompile_done``, or None
        (no worker, or already enqueued)."""
        if (self._pc_thread is None or not isinstance(spec, QuerySpec)
                or isinstance(spec, UpdateSpec)):
            return None
        shapes = _Dispatch.sig_of(args)
        epoch = self.index.shape_epoch
        return self._pc_submit(("spec", spec, shapes, epoch),
                               partial(self._pc_warm_spec, spec, shapes,
                                       epoch))

    def _pc_capture(self, disp: _Dispatch, sig) -> None:
        """Hand a signature's capture to the worker (its second call)."""
        self._pc_submit(("sig", disp.key, sig), partial(disp.warm, sig))

    def _pc_warm_spec(self, spec, shapes, epoch) -> int:
        with self._lock:
            if self.index.shape_epoch != epoch:
                return 0                    # stale: install nothing
            targets = [(self._compile(key, make_fn), sig) for key, make_fn,
                       sig in self._warm_targets(spec, shapes)]
        return sum(bool(d.warm(sig)) for d, sig in targets)

    def _pc_neighbors(self, base) -> None:
        """After a sticky move: warm the adjacent ladder tiers (the next
        escalation and the demotion target) at the signatures this
        base's fused programs have seen, so the NEXT tier change finds
        them realized (captured, on the card). On the card the new
        sticky tier itself too, first: there a program not yet captured
        runs eagerly, at about a capture's host time per call, where the
        reference's next request compiles it once."""
        sticky = self._sticky.get(base)
        if sticky is None:
            return
        sigs = set()
        for k, v in self._cache.items():
            if k[2] == tuple(base) and k[3] == "fused":
                sigs.update(v.sigs())
        if not sigs:
            return
        epoch = self.index.shape_epoch
        tiers = [rule(*sticky) for rule in (self._escalators.get(base),
                                            self._demoters.get(base))
                 if rule is not None]
        tiers = [t for t in tiers if t != sticky]
        if self.cuda_graphs:
            tiers.insert(0, sticky)
        for tier in tiers:
            self._pc_submit(("tier", tuple(base), tier, epoch,
                             tuple(sorted(sigs))),
                            partial(self._pc_warm_tier, tuple(base), tier,
                                    sorted(sigs), epoch))

    def _pc_warm_tier(self, base, tier, sigs, epoch) -> int:
        with self._lock:
            op = self._op_for(base)
            if op is None or self.index.shape_epoch != epoch:
                return 0
            # each width at the wrapping its dispatch takes
            jobs = [(self._compile(self._key(
                base, "fused", tier, qshard=self._use_qshard(sig[0][0][0])),
                lambda: op.fused(*tier)), sig) for sig in sigs]
        return sum(bool(disp.warm(sig)) for disp, sig in jobs)

    def _worker_stream(self):
        """The worker's own stream, at the least priority the card
        offers (the default stream's, which serving runs on: CUDA has
        none lower); a stream of its own, so serving kernels never queue
        behind the worker's work."""
        if self._pc_stream is None:
            least, _greatest = torch.cuda.Stream.priority_range()
            self._pc_stream = torch.cuda.Stream(self.device, priority=least)
        return self._pc_stream

    def _live(self, disp: _Dispatch) -> bool:
        """Is ``disp`` still this executor's, at the current shape epoch
        (executor lock held)?"""
        return (self._cache.get(disp.key) is disp
                and disp.key[5] == self.index.shape_epoch)

    def _warm_async(self, disp: _Dispatch, sig) -> bool:
        """``disp.warm(sig)`` on the worker's thread. Under the executor
        lock: is the program still cached, and what is left to do; a
        graph needs the planes, taken as they are. Outside it, on the
        worker's stream: one eager run on zero inputs where the program
        never ran at these shapes (a neighbour tier, a new width) or the
        worker has not run any program yet (every first-use set-up, of
        the process and of this thread, happens outside a capture), then
        the capture, under the capture lock. A signature the serving
        thread already ran needs no eager run: an eager run costs about
        a capture's host time, and the serving thread runs eagerly until
        the graph is installed. Under the executor lock again: install
        the graph, if its program is still cached at the same shape
        epoch and the planes have not moved; else it is dropped."""
        with self._lock:
            if not self._live(disp) or disp.warmed(sig):
                return False
            if not disp._graphed(sig):
                disp._fns[sig] = disp.fn
                return True
            ran = sig in disp._fns           # eagerly, on the serving side
            parts, bounds = dict(self.parts), self.bounds
        ws = self._worker_stream()
        serve = self._serve_stream or torch.cuda.default_stream(self.device)
        with torch.cuda.device(self.device):
            # static inputs belong to the stream the graph replays on
            with torch.cuda.stream(serve):
                inputs = tuple(torch.empty(s, dtype=getattr(torch, d),
                                           device=self.device)
                               for s, d in sig)
            with torch.cuda.stream(ws):
                ws.wait_stream(serve)
                if not ran or not getattr(_PC_THREAD, "primed", False):
                    zeros = tuple(torch.zeros(s, dtype=getattr(torch, d),
                                              device=self.device)
                                  for s, d in sig)
                    disp.fn(parts, bounds, *zeros)
                    del zeros
                    _PC_THREAD.primed = True
                t0 = time.perf_counter()
                g = _Graph(self, disp.key, disp.fn, inputs, parts, bounds,
                           stream=ws)
                ms = (time.perf_counter() - t0) * 1e3
                done = torch.cuda.Event()
                done.record(ws)
            # the worker's stream idle before the graph is installed (an
            # event wait: a host wait on this thread alone, which the
            # serving thread's sync-debug mode does not count)
            done.synchronize()
        with self._lock:
            self._captured(ms, worker=True)
            if (self._live(disp) and not disp.warmed(sig)
                    and g.ptrs == _plane_ptrs(self.parts, self.bounds)):
                disp._fns[sig] = g
                return True
            dead = [g]
            del g
            self._retire(dead)
            return False

    def _warm_targets(self, spec: QuerySpec, shapes) -> list:
        """(exec_key, make_fn, signature) of each program the steady path
        would run for ``spec`` on arguments of ``shapes`` (the raw
        arguments' (shape, dtype) signature). Derived from the shapes
        alone, as each ``_run_*`` prepares its arguments, so building
        the targets launches nothing on the device. Executor lock
        held."""
        out = []
        idx, cfg, bk = self.index, self.cfg, self.backend
        f32 = "float32"

        def add(key, make_fn, sig):
            out.append((key, make_fn, sig))

        def rows(shape, width):             # (n, width) of a reshape
            return (math.prod(shape) // width, width)

        def qs(shape):                      # the width's wrapping
            return self._use_qshard(int(shape[0]))

        if isinstance(spec, PointQuery):
            q = tuple(shapes[0][0])
            add(self._key(("point",), qshard=qs(q)),
                lambda: L._PointLocal(idx, cfg, bk),
                ((q, f32), (tuple(shapes[1][0]), f32), (q, f32)))
            return out
        if isinstance(spec, (RangeCount, RangeQuery)):
            r = rows(shapes[0][0], 4)
            sig = ((r, f32), (r[:1], f32), (r[:1], f32))
            if isinstance(spec, RangeCount):
                add(self._key(("range_count",), qshard=qs(r)),
                    lambda: L._RangeCountLocal(idx, cfg, bk), sig)
            else:
                self._warm_adaptive(self._op_range(spec.sticky_key()), sig,
                                    add)
            return out
        if isinstance(spec, CircleQuery):
            q = tuple(shapes[0][0])
            sig = ((q + (4,), f32), (q, f32), (q, f32), (q + (3,), f32))
            self._warm_adaptive(
                self._op_circle(spec.sticky_key(), spec.materialize), sig,
                add)
            return out
        if isinstance(spec, Knn):
            q = tuple(shapes[0][0])
            if spec.mode == "exact":
                add(self._key(("knn_exact", spec.k), qshard=qs(q)),
                    lambda: L._KnnExactLocal(idx, cfg, bk, spec.k),
                    ((q, f32), (tuple(shapes[1][0]), f32)))
                return out
            self._warm_adaptive(self._op_knn(spec.sticky_key(), spec.k),
                                ((q, f32), (tuple(shapes[1][0]), f32),
                                 (q[:1], f32)), add)
            return out
        if isinstance(spec, SpatialJoin):
            p = tuple(shapes[0][0])
            sig = ((p, f32), (tuple(shapes[1][0]), "int32"),
                   ((p[0], 6), f32))
            if spec.mode == "full":
                add(self._key(("join_full",), qshard=qs(p)),
                    lambda: L._JoinFullLocal(idx, cfg, bk), sig)
                return out
            self._warm_adaptive(self._op_join(spec.sticky_key()), sig, add)
        return out

    def _warm_adaptive(self, op: _AdaptiveOp, sig, add) -> None:
        """Warm targets of one adaptive family at this signature, as
        ``_adaptive`` dispatches: the sticky fused program (at the
        row-chunked width the bucketed dispatch runs), plus the need
        probe when the width takes the bucketed dispatch; the initial
        strict window tier when no tier is sticky yet."""
        sticky = self._sticky.get(op.base)
        qn = int(sig[0][0][0])
        if sticky is None:
            tier = self._initial.get(op.base, op.initial)
            add(self._key(op.base, "w", tier, qshard=self._use_qshard(qn)),
                lambda: op.window(*tier), sig)
            return
        use_bucket = (self.cfg.tier_buckets and op.probe is not None
                      and qn >= self.cfg.tier_bucket_min
                      and (op.feasible is not None
                           or op.bucketer is not None))
        if use_bucket:
            cand_p = (self.cfg.knn_cand if op.bucketer is not None
                      else sticky[1])
            add(self._key(op.base, "p", (cand_p,)),
                lambda: op.probe(cand_p), sig)
        cw = self._row_chunk(sticky, qn) if use_bucket else qn
        add(self._key(op.base, "fused", sticky,
                      qshard=self._use_qshard(cw)),
            lambda: op.fused(*sticky),
            tuple(((cw,) + s[1:], d) for s, d in sig))

    def warm_for(self, spec: QuerySpec, *args) -> bool:
        """Whether a dispatch of ``spec`` at these arguments' shapes runs
        finished realizations. The serve scheduler asks it after each
        dispatch, to count the width warm: on the CPU always (the
        dispatch realized its programs, as the reference's compile
        does); on the card only when each program of ``_warm_targets``
        is a captured CUDA graph (or one that never graphs), not after
        a dispatch that ran eagerly."""
        if not self.cuda_graphs:
            return True
        with self._lock:
            for key, _make, sig in self._warm_targets(
                    spec, _Dispatch.sig_of(args)):
                disp = self._cache.get(key)
                if disp is None or not disp.warmed(sig):
                    return False
        return True

    # -- the mutable index (DESIGN.md §11) ---------------------------------

    def _recount(self):
        """Refresh the live-point total and density (the kNN radius's
        global estimate): built points less tombstones plus live
        buffered inserts."""
        idx = self.index
        n = int(idx.count.sum())
        if idx.dead is not None:
            n -= int(idx.dead.sum())
        if idx.delta_vid is not None and idx.delta_cap:
            n += int((idx.delta_vid >= 0).sum())
        if self._axis is None:
            self._count_all = idx.count
        else:
            # every shard's points, and every partition's count (the kNN
            # radius reads the count of any partition)
            (n,) = self._agree([n], "sum")
            self._count_all = self._axis.all_gather0(idx.count)
        self.n_total = n
        self.density = max(n / self.area, 1e-30)

    def _bind(self, index, leaves):
        """``index`` with the partition fields of ``leaves`` and the boxes
        taken from the executor's own planes."""
        return dataclasses.replace(
            index, part_bounds=self.bounds,
            **{_LEAF_FIELDS[k]: self.parts[k] for k in leaves
               if k in _LEAF_FIELDS})

    def _install_index(self, new_index, leaves=None):
        """Install a mutated index: write its partition planes (only
        ``leaves`` when given and neither the shape epoch nor the leaf
        set moved: inserts never move the sorted data plane) and boxes
        into the executor's own (in place where shape and dtype hold and
        graphs are on, so a captured graph goes on reading the live
        index); drop the programs of a superseded shape epoch,
        and recount."""
        shape_changed = new_index.shape_epoch != self.index.shape_epoch
        names = L.part_leaf_names(new_index)
        if shape_changed or leaves is None or names != set(self.parts):
            leaves = names
        parts = {k: v for k, v in self.parts.items() if k in names}
        put = _write_into if self.cuda_graphs else (lambda _old, new: new)
        for k, v in L.part_arrays(new_index, leaves=leaves).items():
            parts[k] = put(parts.get(k), v)
        self.parts = parts
        self.bounds = put(self.bounds, new_index.part_bounds)
        self.index = self._bind(new_index, leaves)
        if shape_changed:
            self._evict_stale()
        self._recount()

    def _update_fn(self, kind: str, b: int, fn):
        """Update programs cache like queries: one dispatcher per (batch
        size, delta capacity) variant, which `_evict_stale` sweeps with
        a superseded shape epoch. They run eagerly (host-driven)."""
        key = self._key((kind,), "u", (b, self.index.delta_cap))
        if key not in self._cache:
            self._cache[key] = _Dispatch(self, key, fn, prefix=0)
        self.dispatches += 1
        return self._cache[key]

    def _note_occupancy(self, touched):
        """Schedule the deferred re-fit of the touched partitions (global
        ids) whose delta occupancy crossed the threshold (run by
        maintain()). On a mesh each shard flags its own, and the flags
        are OR-ed over a P-long vector, so every rank schedules the
        same."""
        occ = M.delta_occupancy(self.index)
        touched = np.asarray(touched, np.int64)
        local, mine = self._shard_rows(touched)
        flags = np.zeros(self.p_total, np.int64)
        flags[touched[mine][occ[local[mine]] > self.cfg.delta_occupancy]] = 1
        flags = self._agree(flags, "max")
        self._refit_pending.update(int(p) for p in np.flatnonzero(flags))

    def _dirty(self) -> np.ndarray:
        """Global ids of the partitions with buffered inserts or
        tombstones (OR-ed over the shards on a mesh)."""
        dirty = M.dirty_partitions(self.index)
        flags = np.zeros(self.p_total, np.int64)
        flags[dirty.astype(np.int64) + self.index.part_offset] = 1
        return np.flatnonzero(self._agree(flags, "max")).astype(np.int32)

    def _with_delta_state(self):
        """The index, given delta bookkeeping if it was built without."""
        if self.index.delta_count is None:
            self._install_index(M.with_delta_capacity(self.index, 0,
                                                      floor=0))
        return self.index

    def _run_insert(self, args):
        """InsertBatch: append to the target partitions' delta buffers.
        Returns the assigned vids (B,) int32, numpy. Host-driven like
        build_index: the capacity check reads the host."""
        xs, ys = self._f32(args[0]), self._f32(args[1])
        b = int(xs.shape[0])
        if b == 0:
            return np.zeros((0,), np.int32)
        idx = self._with_delta_state()
        pid = M.assign_insert(idx, xs, ys).to(torch.int32)  # as the reference's
        # out-of-domain inserts land in the overflow grid; widen its box
        # so the global filter (rect, circle, kNN and join candidates)
        # sees them, not only the point probe, which always reads the
        # overflow grid. Keys still clip to key_spec.bounds; the refine
        # compares the stored coordinates, so answers stay exact. The
        # extremes are taken over the flushed coordinates, as XLA:CPU
        # compares them (a -1e-45 among others reads as -0.0).
        ob = idx.part_bounds[idx.overflow].cpu().numpy()
        fx, fy = flush_denormals(xs), flush_denormals(ys)
        nb = [min(ob[0], float(fx.min())), min(ob[1], float(fy.min())),
              max(ob[2], float(fx.max())), max(ob[3], float(fy.max()))]
        if nb != ob.tolist():
            pb = idx.part_bounds.clone()
            pb[idx.overflow] = torch.as_tensor(np.asarray(nb, np.float32),
                                               device=self.device)
            idx = dataclasses.replace(idx, part_bounds=pb)
            self._install_index(idx, leaves=())
        key = K.make_keys(xs, ys, self.spec)
        vids = torch.arange(self.next_vid, self.next_vid + b,
                            dtype=torch.int32, device=self.device)
        rows = pid.cpu().numpy()
        if self._axis is not None:
            # every rank numbers the whole batch and keeps its own rows
            local, mine = self._shard_rows(rows)
            sel = torch.as_tensor(np.flatnonzero(mine), device=self.device)
            rows = local[mine]
            pid = torch.as_tensor(rows.astype(np.int32), device=self.device)
            key, xs, ys, vids = (a.index_select(0, sel)
                                 for a in (key, xs, ys, vids))
        need = int((idx.delta_count.cpu().numpy() + np.bincount(
            rows, minlength=idx.num_partitions)).max())
        (need,) = self._agree([need])   # the capacity of the whole index
        if need > idx.delta_cap:
            idx = M.with_delta_capacity(idx, need, floor=self.cfg.delta_cap)
            self._install_index(idx)     # a new leaf set: full refresh
        fn = self._update_fn("insert", int(pid.shape[0]), M.scatter_inserts)
        dk, dx, dy, dv, dc = fn(
            idx.delta_key, idx.delta_x, idx.delta_y, idx.delta_vid,
            idx.delta_count, pid, key, xs, ys, vids)
        idx = dataclasses.replace(
            idx, delta_key=dk, delta_x=dx, delta_y=dy, delta_vid=dv,
            delta_count=dc, epoch=idx.epoch + 1)
        self.next_vid += b
        self.updates += 1
        self._install_index(idx, leaves=("dx", "dy", "dvid", "dcount"))
        self._note_occupancy(np.unique(rows + idx.part_offset))
        return np.arange(self.next_vid - b, self.next_vid, dtype=np.int32)

    def _run_delete(self, args):
        """DeleteBatch: tombstone every live copy of each (x, y) in its
        two candidate partitions (main plane and delta). Returns the
        number of removed points."""
        xs, ys = self._f32(args[0]), self._f32(args[1])
        b = int(xs.shape[0])
        if b == 0:
            return 0
        idx = self._with_delta_state()
        pid1 = M.assign_insert(idx, xs, ys).to(torch.int32)
        pid2 = torch.full_like(pid1, idx.overflow)
        touched = np.unique(np.append(pid1.cpu().numpy(), idx.overflow))
        shard = ()
        if self._axis is not None:
            # each candidate as this shard's row, and whether it is one
            (l1, m1), (l2, m2) = (self._shard_rows(p.cpu().numpy())
                                  for p in (pid1, pid2))
            pid1, pid2 = (torch.as_tensor(lc.astype(np.int32),
                                          device=self.device)
                          for lc in (l1, l2))
            shard = (torch.as_tensor(np.stack([m1, m2], 1),
                                     device=self.device),)
        fn = self._update_fn("delete", b, M.apply_deletes)
        nx, ny, nv, dx, dy, dv, dead2, removed = fn(
            idx.x, idx.y, idx.vid, idx.count, idx.delta_x, idx.delta_y,
            idx.delta_vid, idx.delta_count, idx.dead, xs, ys, pid1, pid2,
            *shard)
        idx = dataclasses.replace(
            idx, x=nx, y=ny, vid=nv, delta_x=dx, delta_y=dy,
            delta_vid=dv, dead=dead2, epoch=idx.epoch + 1)
        self.updates += 1
        leaves = ("x", "y", "vid")
        if idx.delta_cap:
            leaves = leaves + ("dx", "dy", "dvid")
        self._install_index(idx, leaves=leaves)
        self._note_occupancy(touched)
        (removed,) = self._agree([int(removed)], "sum")
        return removed

    def refit(self, touched=None):
        """Compaction + per-partition spline re-fit
        (``mutate.refit_partitions``): merge the delta buffers, drop
        tombstones and re-fit ONLY the given partitions (default: every
        dirty one). Returns the list of partition ids re-fit.
        Thread-safe."""
        with self._lock:
            return self._refit_locked(touched)

    def _refit_locked(self, touched=None):
        idx = self.index
        if idx.delta_count is None:
            return []
        if touched is None:
            touched = self._dirty()
        touched = np.unique(np.asarray(touched, np.int32))
        if touched.size == 0:
            return []
        # every shard re-fits its own rows; the statics are agreed
        local, mine = self._shard_rows(touched)
        new = M.refit_partitions(idx, local[mine],
                                 agree=lambda v: self._agree([v])[0])
        self.refits += 1
        self._refit_pending.difference_update(int(t) for t in touched)
        self._install_index(new)         # the data plane moved: refresh
        # shed a burst-grown delta buffer once fully compacted (the 2x
        # floor hysteresis rate-limits grow/shrink ping-pong)
        idx2 = self.index
        if (idx2.delta_cap > 2 * max(self.cfg.delta_cap, 1)
                and self._dirty().size == 0):
            self._install_index(
                M.shrink_delta_capacity(idx2, self.cfg.delta_cap))
        return [int(t) for t in touched]

    # -- the adaptive policy ----------------------------------------------

    def _adaptive(self, op: _AdaptiveOp, pargs, strict: bool,
                  start: Optional[Tuple[int, int]] = None):
        """Sticky tier + geometric escalation + exact fallback, or the
        fused serving program. ``start`` is a one-off user tier: it runs
        the strict loop and never updates the sticky state."""
        self._initial.setdefault(op.base, op.initial)
        self._escalators[op.base] = op.escalate
        self._demoters[op.base] = op.demote
        sticky = self._sticky.get(op.base)
        qs = self._use_qshard(pargs[0].shape[0])
        if sticky is not None and not strict and start is None:
            if (self.cfg.tier_buckets and op.probe is not None
                    and pargs[0].shape[0] >= self.cfg.tier_bucket_min
                    and (op.feasible is not None
                         or op.bucketer is not None)):
                return self._run_bucketed(op, pargs, sticky)
            # steady state: the fused program, no host read; ok is
            # stashed, unread, for maintain()
            fn = self._compile(self._key(op.base, "fused", sticky,
                                         qshard=qs),
                               lambda: op.fused(*sticky))
            out, ok = self._call(fn, *pargs)
            self._pending[op.base] = (sticky, ok)
            return op.post(out)
        cap, cand = start or sticky or op.initial
        while True:
            fn = self._compile(self._key(op.base, "w", (cap, cand),
                                         qshard=qs),
                               lambda: op.window(cap, cand))
            res = self._call(fn, *pargs)
            hit = self._all_ok(op.get_ok(res))
            maxed = op.maxed(cap, cand)
            if hit or (maxed and op.sticky_on_maxed):
                if start is None:
                    self._set_sticky(op.base, (cap, cand))
                return op.finalize(res)
            if maxed:
                break
            cap, cand = op.escalate(cap, cand)
        return op.fallback(pargs, res)

    # -- the wide-batch tier-bucketed dispatch (DESIGN.md §13) -----------

    def _ladder_tiers(self, op: _AdaptiveOp, sticky) -> list:
        """The escalation ladder's tiers from the initial one up to the
        sticky tier, ascending; a sticky tier off the ladder gives the
        one sticky bucket (correctness never depends on the ladder)."""
        tiers = [op.initial]
        cur = op.initial
        while cur != sticky:
            nxt = op.escalate(*cur)
            if nxt == cur or len(tiers) > 64:
                return [sticky]
            cur = nxt
            tiers.append(cur)
        return tiers

    def _feasible_rect(self, materialize: bool) -> Callable:
        """The rect families' rule on the (Q, 3) need probe [ncand, need,
        needsum]: a feasible row is ok at the tier (its candidates are
        complete, every learned window fits cap, and, materializing, the
        keep width drops no id), so it gives the sticky tier's result
        there (up to the -1 padding ``_norm_width`` adds)."""
        n_pad = self.index.n_pad
        p_total = self.p_total
        d_cap = self.index.delta_cap

        def feasible(probe, cap, cand):
            cap_e = min(cap, n_pad)
            cand_e = min(cand, p_total)
            ok = (probe[:, 0] <= cand_e) & (probe[:, 1] <= cap_e)
            if materialize:
                ok = ok & ((probe[:, 2] + cand_e * d_cap)
                           <= max(cap_e * 8, 256))
            return ok

        return feasible

    def _owidth_rect(self) -> Callable:
        """The rect programs' materialized vid plane width at a tier:
        ``local_ops._keep_window``'s keep bound, so a light bucket pads
        to the sticky tier's width bitwise."""
        n_pad = self.index.n_pad
        p_total = self.p_total
        d_cap = self.index.delta_cap
        shards = self._part_shards()   # the gathered plane: a slab each

        def owidth(cap, cand):
            cap_e = min(cap, n_pad)
            cand_e = min(cand, p_total)
            return min(shards * cand_e * (4 * cap_e + d_cap),
                       max(cap_e * 8, 256))

        return owidth

    def _knn_bucketer(self, k: int) -> Callable:
        """Rank kNN rows by their predicted resolving round on the
        (Q, J, 3) need probe [need, tot, nin], on the device: rows whose
        candidate mass reaches 2k within the probed rounds (and whose
        window fits the sticky cap and cand) rank 0 (round 0 or 1) or 1;
        the rest rank 2, the hard bucket. Every rank runs at the sticky
        tier: the ranks split padded widths, never values."""
        n_pad = self.index.n_pad
        cand = min(self.cfg.knn_cand, self.p_total)
        j_max = L._KnnNeedLocal.J

        def bucketer(probe, cap, _cand):
            cap_e = min(cap, n_pad)
            need, tot, nin = probe[..., 0], probe[..., 1], probe[..., 2]
            enough = tot >= 2 * k                       # (Q, J)
            # argmax: the first round with enough mass
            jest = torch.where(enough.any(1),
                               enough.to(torch.int32).argmax(1), j_max)
            jc = torch.clamp(jest, max=j_max - 1)[:, None]
            hard = ((jest >= j_max) | (need.gather(1, jc)[:, 0] > cap_e)
                    | (nin.gather(1, jc)[:, 0] > cand))
            return torch.where(hard, 2, torch.where(jest <= 1, 0, 1))

        return bucketer

    def _norm_width(self, op: _AdaptiveOp, out, tier, sticky):
        """-1-pad a light bucket's materialized vid plane to the sticky
        tier's width (both are -1 past the kept ids, so the padded plane
        is the sticky run's bit for bit)."""
        if op.owidth is None or tier == sticky:
            return out
        pad = op.owidth(*sticky) - out[1].shape[1]
        if pad <= 0:
            return out
        vids = torch.nn.functional.pad(out[1], (0, pad), value=-1)
        return (out[0], vids) + tuple(out[2:])

    def _row_chunk(self, tier, width: int) -> int:
        """Most rows per fused call at ``tier``: rows x (cap * cand)
        stays within ``row_chunk_elems``, a power of two (it tiles the
        power-of-two buckets, so every chunk has one shape) of at least
        256 rows."""
        per_row = max(1, int(tier[0]) * int(tier[1]))
        cw = max(1, self.cfg.row_chunk_elems // per_row)
        cw = max(256, 1 << (cw.bit_length() - 1))
        return min(width, cw)

    def _fused_chunked(self, op: _AdaptiveOp, tier, bargs, width: int):
        """``bargs`` (width rows) through the tier's fused program in
        ``_row_chunk``-row slices, (out, ok) concatenated. Each output row
        is a function of its row and the tier, so the result is one
        call's. A short tail chunk is padded with its own row 0 (a real
        query) to the chunk width and un-padded."""
        cw = self._row_chunk(tier, width)
        fn = self._compile(self._key(op.base, "fused", tier,
                                     qshard=self._use_qshard(cw)),
                           lambda: op.fused(*tier))
        if cw >= width:
            return self._call(fn, *bargs)
        outs, oks = [], []
        for s in range(0, width, cw):
            cargs = tuple(a[s:s + cw] for a in bargs)
            tail = cw - cargs[0].shape[0]
            if tail > 0:
                cargs = _pad_rows(cargs, tail)
            out, ok = self._call(fn, *cargs)
            if tail > 0:
                out, ok = _tree(lambda a: a[:-tail], out), ok[:-tail]
            outs.append(out)
            oks.append(ok)
        return (_tree(lambda *a: torch.cat(a), *outs), torch.cat(oks))

    def _run_bucketed(self, op: _AdaptiveOp, pargs, sticky):
        """The wide-batch tier-bucketed dispatch (DESIGN.md §13).

        The need probe ranks every row on the device: rect-family rows
        at the lowest ladder tier where the probe guarantees a fit (if
        they fit at the sticky tier too; otherwise a hard bucket at the
        sticky tier, where a serial call would run them), kNN rows by
        predicted resolving round, all at the sticky tier. One host read
        brings back the bucket sizes (``probe_syncs``, not
        ``host_syncs``: the zero-sync contract concerns the ok flags).
        Each bucket's rows, in request order, are padded to a power of
        two with its own row 0 and run through the fused program of its
        tier; the outputs scatter back by the inverse permutation. Each
        output row depends only on (row, tier), so the result is one
        sticky-tier call's, bit for bit."""
        qn = pargs[0].shape[0]
        cand_p = (self.cfg.knn_cand if op.bucketer is not None
                  else sticky[1])
        pfn = self._compile(self._key(op.base, "p", (cand_p,)),
                            lambda: op.probe(cand_p))
        probe = self._call(pfn, *pargs)
        if op.bucketer is not None:
            rank = op.bucketer(probe, *sticky)
            tier_of = [sticky] * 3
        else:
            tier_of = self._ladder_tiers(op, sticky)
            nb = len(tier_of)
            rank = torch.full((qn,), nb - 1, dtype=torch.int64,
                              device=probe.device)
            for i in reversed(range(nb - 1)):
                rank = torch.where(op.feasible(probe, *tier_of[i]), i, rank)
            # rows not guaranteed at the sticky tier: a hard bucket there,
            # so the exact fallback fires on it alone
            rank = torch.where(op.feasible(probe, *sticky), rank, nb)
            tier_of = tier_of + [sticky]
        sizes = torch.zeros(len(tier_of), dtype=torch.int64,
                            device=rank.device)
        sizes.scatter_add_(0, rank, torch.ones_like(rank))
        sizes = sizes.tolist()          # the one host read of the call
        self.probe_syncs += 1
        present = [rk for rk, n in enumerate(sizes) if n]
        if len(present) == 1 and tier_of[present[0]] == sticky:
            # one bucket at the sticky tier: still row-chunked
            out, ok = self._fused_chunked(op, sticky, pargs, qn)
            self._pending[op.base] = (sticky, ok)
            return op.post(out)
        # rows grouped by rank, each group in request order
        perm = torch.sort(rank, stable=True).indices
        outs, oks, lo = [], [], 0
        for rk in present:
            bl = sizes[rk]
            sel = perm[lo:lo + bl]
            lo += bl
            tier = tier_of[rk]
            plen = 1 << (bl - 1).bit_length()
            bargs = tuple(a.index_select(0, sel) for a in pargs)
            if plen > bl:
                bargs = _pad_rows(bargs, plen - bl)
            out, ok = self._fused_chunked(op, tier, bargs, plen)
            if plen > bl:
                out, ok = _tree(lambda a: a[:bl], out), ok[:bl]
            outs.append(self._norm_width(op, out, tier, sticky))
            oks.append(ok)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(qn, device=perm.device)
        merged = _tree(lambda *a: torch.cat(a).index_select(0, inv), *outs)
        ok_all = torch.cat(oks).index_select(0, inv)
        self._pending[op.base] = (sticky, ok_all)
        return op.post(merged)

    def _set_sticky(self, base, variant):
        old = self._sticky.get(base)
        self._sticky[base] = variant
        if old != variant:
            # a new tier starts its demotion clock from zero
            self._ok_streak[base] = 0
            self._evict(base)
            if self._pc_thread is not None:
                # the adjacent ladder tiers to the worker, so the NEXT
                # move finds them captured
                self._pc_neighbors(base)

    def _maxed_both(self, cap, cand):
        return (cap >= self.index.n_pad and cand >= self.p_total)

    def _escalate_both(self, cap, cand):
        return (min(cap * 4, self.index.n_pad),
                min(cand * 2, self.p_total))

    def _ladder_demote(self, initial, escalate):
        """Demote to the PREDECESSOR on the op's escalation ladder
        (initial, escalate(initial), ...), not to an arithmetic inverse,
        which lands off the ladder where escalation clamped."""
        def demote(cap, cand):
            prev = cur = initial
            for _ in range(64):          # ladders are O(log) long
                if cur == (cap, cand):
                    return prev
                nxt = escalate(*cur)
                if nxt == cur:
                    break                # maxed without finding it
                prev, cur = cur, nxt
            return (cap, cand)           # off-ladder: stay put
        return demote

    # -- per-kind preparation and dispatch ------------------------------

    def _rect_keys(self, rects):
        klo, khi = K.rect_key_range(rects, self.spec)
        return K.keys_to_f32(klo), K.keys_to_f32(khi)

    def _run_point(self, args):
        qx, qy = self._f32(args[0]), self._f32(args[1])
        qk = K.keys_to_f32(K.make_keys(qx, qy, self.spec))
        fn = self._compile(self._key(("point",),
                                     qshard=self._use_qshard(qx.shape[0])),
                           lambda: L._PointLocal(self.index, self.cfg,
                                                 self.backend))
        return self._call(fn, qx, qy, qk) > 0

    def _run_range_count(self, args):
        rects = self._f32(args[0]).reshape(-1, 4)
        klo, khi = self._rect_keys(rects)
        fn = self._compile(self._key(("range_count",),
                                     qshard=self._use_qshard(rects.shape[0])),
                           lambda: L._RangeCountLocal(self.index, self.cfg,
                                                      self.backend))
        return self._call(fn, rects, klo, khi)

    def _op_range(self, base):
        idx, cfg, bk = self.index, self.cfg, self.backend

        def fused(cap, cand):
            # counts stay exact via the exact range count; ok still
            # flags each query's materialization completeness
            return L._CondFusedLocal(
                idx, cfg, bk,
                primary=L._RangeWindowLocal(idx, cfg, bk, cap, cand),
                fallback=L._RangeCountLocal(idx, cfg, bk),
                fb_args=(0, 1, 2),
                get_ok=lambda pri: pri[2],
                merge_ok=lambda pri: pri,
                merge_fb=lambda pri, fb: (fb, pri[1], pri[2]))

        return _AdaptiveOp(
            base=base, initial=(cfg.range_cap, cfg.range_cand),
            window=lambda cap, cand: L._RangeWindowLocal(idx, cfg, bk,
                                                         cap, cand),
            get_ok=lambda res: res[2], finalize=lambda res: res,
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=True, fallback=None, fused=fused,
            demote=self._ladder_demote((cfg.range_cap, cfg.range_cand),
                                       self._escalate_both),
            probe=lambda c: L._WindowNeedLocal(idx, cfg, bk, c,
                                               lambda *q: q[0], 3),
            feasible=self._feasible_rect(True),
            owidth=self._owidth_rect())

    def _run_range(self, spec: RangeQuery, args, strict):
        rects = self._f32(args[0]).reshape(-1, 4)
        klo, khi = self._rect_keys(rects)
        op = self._op_range(spec.sticky_key())
        start = None
        if spec.cap is not None:
            # the user cap overrides the starting tier; cand follows sticky
            _, cand0 = self._sticky.get(op.base, op.initial)
            start = (min(spec.cap, self.index.n_pad), cand0)
        return self._adaptive(op, (rects, klo, khi), strict, start=start)

    def _circle_args(self, args):
        """(rects, klo, khi, circ) of (cx, cy, r): the circles' MBRs and
        their key ranges, and the (Q, 3) circles."""
        cx, cy, r = (self._f32(a) for a in args)
        rects = Q.circle_mbrs(cx, cy, r)
        klo, khi = self._rect_keys(rects)
        return rects, klo, khi, torch.stack([cx, cy, r], -1)

    def _circle_exact(self, pargs):
        """Exact in-circle counts: the full-refine program behind the
        adaptive circle query (the reference's fallback program)."""
        fn = self._compile(self._key(("circle_exact",), qshard=self._use_qshard(
            pargs[0].shape[0])),
                           lambda: L._CircleCountLocal(self.index, self.cfg,
                                                       self.backend))
        return self._call(fn, *pargs)

    def _op_circle(self, base, materialize: bool):
        idx, cfg, bk = self.index, self.cfg, self.backend

        def window(cap, cand):
            return L._CircleWindowLocal(idx, cfg, bk, cap, cand,
                                        materialize)

        def fused(cap, cand):
            if materialize:
                return L._CondFusedLocal(
                    idx, cfg, bk, primary=window(cap, cand),
                    fallback=L._CircleCountLocal(idx, cfg, bk),
                    fb_args=(0, 1, 2, 3),
                    get_ok=lambda pri: pri[2],
                    merge_ok=lambda pri: pri,
                    merge_fb=lambda pri, fb: (fb, pri[1], pri[2]))
            return L._CondFusedLocal(
                idx, cfg, bk, primary=window(cap, cand),
                fallback=L._CircleCountLocal(idx, cfg, bk),
                fb_args=(0, 1, 2, 3),
                get_ok=lambda pri: pri[1],
                merge_ok=lambda pri: pri[0],
                merge_fb=lambda pri, fb: fb)

        def fallback(pargs, res):
            cnt = self._circle_exact(pargs)
            if materialize:    # exact counts; window ids flagged by ok
                return cnt, res[1], res[2]
            return cnt

        return _AdaptiveOp(
            base=base, initial=(cfg.circle_cap, cfg.circle_cand),
            window=window, get_ok=lambda res: res[-1],
            finalize=(lambda res: res) if materialize
            else (lambda res: res[0]),
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=False, fallback=fallback, fused=fused,
            demote=self._ladder_demote((cfg.circle_cap, cfg.circle_cand),
                                       self._escalate_both),
            probe=lambda c: L._WindowNeedLocal(idx, cfg, bk, c,
                                               lambda *q: q[0], 4),
            feasible=self._feasible_rect(materialize),
            owidth=self._owidth_rect() if materialize else None)

    def _run_circle(self, spec: CircleQuery, args, strict):
        op = self._op_circle(spec.sticky_key(), spec.materialize)
        return self._adaptive(op, self._circle_args(args), strict)

    def _knn_r0(self, qx, qy, k):
        """Initial radius per query (paper Eq. (1), r = sqrt(k / (pi d)),
        with the local density of each query's nearest partition), in
        the reference's dtypes and order: the global estimate in float64
        on the host, the rest in float32, the box distance unfused (the
        reference runs it eagerly, outside any compiled program). XLA's
        eager ops read denormals as zero and flush tiny results too."""
        r0g = float(np.sqrt(max(k, 1) / (np.pi * self.density)))
        zero = _f32_const(0.0, qx)
        b = flush_denormals(self.bounds)
        dx = torch.maximum(torch.maximum(b[:, 0] - qx[:, None],
                                         qx[:, None] - b[:, 2]), zero)
        dy = torch.maximum(torch.maximum(b[:, 1] - qy[:, None],
                                         qy[:, None] - b[:, 3]), zero)
        # the differences are only squared, and a sum of two flushed
        # squares is 0 or at least 2^-126: no flush needed there
        pid0 = torch.argmin(mul_f32(dx, dx) + mul_f32(dy, dy), dim=1)
        b0 = b[pid0]
        area0 = torch.maximum(mul_f32(sub_f32(b0[:, 2], b0[:, 0]),
                                      sub_f32(b0[:, 3], b0[:, 1])),
                              _f32_const(1e-30, qx))
        d0 = torch.maximum(self._count_all[pid0] / area0,
                           _f32_const(1e-30, qx))
        r0 = torch.sqrt(_f32_const(k, qx) / (_f32_const(np.pi, qx) * d0))
        return torch.maximum(r0, _f32_const(r0g, qx))

    def _knn_exact(self, k, qx, qy):
        fn = self._compile(self._key(("knn_exact", k),
                                     qshard=self._use_qshard(qx.shape[0])),
                           lambda: L._KnnExactLocal(self.index, self.cfg,
                                                    self.backend, k))
        return self._call(fn, qx, qy)

    def _op_knn(self, base, k):
        idx, cfg, bk = self.index, self.cfg, self.backend
        cand = cfg.knn_cand

        def fused(cap, _cand):
            def pruned(c):      # the serving form: fixed rounds
                return L._KnnPrunedLocal(idx, cfg, bk, k, cand, c,
                                         fixed_rounds=True)

            def merge_fb(pri, fb):
                okc = pri[2][:, None]
                return (torch.where(okc, pri[0], fb[0]),
                        torch.where(okc, pri[1], fb[1]))

            # fallback ladder: overflowed rows retry at the next cap
            # before the exact scan
            exact = L._KnnExactLocal(idx, cfg, bk, k)
            esc = min(cap * 4, idx.n_pad)
            if esc > cap:
                fb = L._KnnLadderLocal(idx, cfg, bk, primary=pruned(esc),
                                       exact=exact)
                fb_args = (0, 1, 2)
            else:
                fb, fb_args = exact, (0, 1)
            return L._CondFusedLocal(
                idx, cfg, bk, primary=pruned(cap), fallback=fb,
                fb_args=fb_args, get_ok=lambda pri: pri[2],
                merge_ok=lambda pri: (pri[0], pri[1]), merge_fb=merge_fb)

        def fallback(pargs, res):
            # unresolved queries: the exact scan
            neg, vid, ok = res
            nege, vide = self._knn_exact(k, *pargs[:2])
            okc = ok[:, None]
            return (torch.where(okc, -neg, -nege),
                    torch.where(okc, vid, vide))

        return _AdaptiveOp(
            base=base, initial=(cfg.knn_cap, cand),
            window=lambda cap, _cand: L._KnnPrunedLocal(
                idx, cfg, bk, k, cand, cap),
            get_ok=lambda res: res[2],
            finalize=lambda res: (-res[0], res[1]),
            escalate=lambda cap, cd: (min(cap * 4, idx.n_pad), cd),
            maxed=lambda cap, cd: cap >= idx.n_pad,
            sticky_on_maxed=False, fallback=fallback, fused=fused,
            post=lambda r: (-r[0], r[1]),
            demote=lambda cap, cd: (max(cap // 4, cfg.knn_cap), cd),
            probe=lambda c: L._KnnNeedLocal(idx, cfg, bk, c),
            bucketer=self._knn_bucketer(k))

    def _run_knn(self, spec: Knn, args, strict):
        qx, qy = self._f32(args[0]), self._f32(args[1])
        if spec.mode == "exact":
            neg, vid = self._knn_exact(spec.k, qx, qy)
            return -neg, vid
        r0 = self._knn_r0(qx, qy, spec.k)
        op = self._op_knn(spec.sticky_key(), spec.k)
        return self._adaptive(op, (qx, qy, r0), strict)

    def _join_full(self, pargs):
        fn = self._compile(self._key(("join_full",), qshard=self._use_qshard(
            pargs[0].shape[0])),
                           lambda: L._JoinFullLocal(self.index, self.cfg,
                                                    self.backend))
        return self._call(fn, *pargs)

    def _op_join(self, base):
        idx, cfg, bk = self.index, self.cfg, self.backend

        def fused(cap, cand):
            return L._CondFusedLocal(
                idx, cfg, bk,
                primary=L._JoinLocal(idx, cfg, bk, cap, cand),
                fallback=L._JoinFullLocal(idx, cfg, bk),
                fb_args=(0, 1, 2),
                get_ok=lambda pri: pri[1],
                merge_ok=lambda pri: pri[0],
                merge_fb=lambda pri, fb: fb)

        return _AdaptiveOp(
            base=base, initial=(cfg.join_cap, cfg.join_cand),
            window=lambda cap, cand: L._JoinLocal(idx, cfg, bk, cap, cand),
            get_ok=lambda res: res[1], finalize=lambda res: res[0],
            escalate=self._escalate_both, maxed=self._maxed_both,
            sticky_on_maxed=False,
            fallback=lambda pargs, res: self._join_full(pargs), fused=fused,
            demote=self._ladder_demote((cfg.join_cap, cfg.join_cand),
                                       self._escalate_both),
            probe=lambda c: L._WindowNeedLocal(idx, cfg, bk, c,
                                               lambda *q: q[2][:, :4], 3,
                                               z_depth=3),
            feasible=self._feasible_rect(False))

    def _join_args(self, args):
        """(polys, n_edges, mbr_k) of (polys, n_edges): mbr_k (PG, 6) holds
        each polygon's MBR over its first n_edges vertices and the MBR's
        key range."""
        polys = self._f32(args[0])
        n_edges = self._i32(args[1])
        em = L._edge_mask(polys, n_edges)
        big = _f32_const(3e38, polys)
        mbrs = torch.cat([torch.where(em, polys, big).amin(1),
                          torch.where(em, polys, -big).amax(1)], -1)
        klo, khi = self._rect_keys(mbrs)
        return polys, n_edges, torch.cat([mbrs, klo[:, None], khi[:, None]],
                                         -1)

    def _run_join(self, spec: SpatialJoin, args, strict):
        pargs = self._join_args(args)
        if spec.mode == "full":
            return self._join_full(pargs)
        return self._adaptive(self._op_join(spec.sticky_key()), pargs,
                              strict)
