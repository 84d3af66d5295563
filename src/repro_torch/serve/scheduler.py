"""Streaming serve scheduler: request queue, adaptive micro-batching and
off-hot-path maintenance (DESIGN.md §12).

``SpatialServeSession`` is call-and-wait: one caller, one ``submit``,
one dispatch. The traffic LiLIS targets, many small concurrent point,
range, circle and kNN requests plus a live ingest stream, needs a front
door: a request queue drained by a background worker that COALESCES
concurrent requests into micro-batches and defers maintenance to idle
time. This module is that front door:

  submit(spec, *args) -> Ticket      non-blocking; resolves when the
                                     micro-batch that carried the
                                     request completed on the device
  drain()                            deterministic synchronous pump
                                     (start=False)
  request_maintain() -> Ticket       explicit maintenance barrier

Scheduling rules:

  - FIFO with write barriers: requests are processed in arrival order;
    reads between two writes may be batched together (reads commute),
    but no read is hoisted across a write enqueued before it. A read
    enqueued after an ``InsertBatch`` / ``DeleteBatch`` therefore
    observes that write's epoch (``Ticket.epoch`` carries the
    read-your-writes token).
  - Adaptive micro-batching: reads of one spec with concat-compatible
    arguments (the same trailing shapes and dtype; a numpy array and a
    tensor of one dtype are compatible) coalesce along the query axis,
    up to a per-spec cap (``micro_batch_caps``) clamped to
    ``serve_max_batch``. Batch widths are padded to the next power of
    two by repeating row 0 (a real, resolvable query), so results stay
    bitwise those of serial ``submit()``. On the card each width is a
    CUDA graph per program, so the padding keeps the graphs logarithmic
    in ``serve_max_batch``; the width also decides whether the executor
    takes the tier-bucketed dispatch (``tier_bucket_min``) and so how
    the sticky tiers move: the padding keeps that state the reference's.
  - Warm-width handoff (DESIGN.md §14, async precompilation): in worker
    mode with ``EngineConfig.serve_async_precompile`` (the default) the
    scheduler starts the executor's precompile worker. A (spec, width)
    not yet warm is handed to the worker (``precompile_async``) and the
    batch pads to the nearest LARGER warm width meanwhile (counted in
    ``width_fallbacks``; ``precompile_pending`` counts the handed-over
    widths not yet done). A width counts as warm once the worker
    finished it, or after a dispatch at it ran finished realizations
    (``Executor.warm_for``: on the card only a captured CUDA graph, not
    an eager run; on the CPU every dispatch); on the card the widths the
    executor captured before the scheduler met the signature are warm
    from its first batch. On the card a batch pads at most
    ``_MAX_CHUNKS``-fold, and one that no such larger warm width holds
    runs as at most ``_MAX_CHUNKS`` replays at the largest warm width
    below it (``Executor.run_rows``), since there an uncaptured width
    runs eagerly, which costs about what its capture would. Extra row-0 padding and row chunks are bitwise
    neutral, so only WHERE the capture happens moves: never on the
    serving thread. The worker's failed captures are counted in the
    executor's ``stats()["async_capture_errors"]``. Drain mode
    (``start=False``) starts no worker.
  - Consecutive ``InsertBatch`` writes merge into one update dispatch
    (the ingest-stream fast path); the assigned vids are routed back per
    request. Deletes return one count each and never merge.
  - ``maintain()`` (sticky re-tune and occupancy-triggered re-fit) runs
    ONLY when the queue is idle, never between queued requests, or at an
    explicit ``request_maintain()`` barrier. The event log records the
    queue length at every maintenance run; ``stats()["maintain_busy"]``
    must stay 0.

A ticket resolves only after its batch completed on the device: the
worker records a CUDA event after the dispatch and waits on it (on the
CPU there is nothing to wait for). A batch that raises fails its own
tickets, and only those.

Thread model: ONE worker thread owns every executor dispatch (the
``Executor`` is also locked, so direct ``session.submit`` calls may race
the scheduler safely). With ``start=False`` no thread is created and
``drain()`` pumps the same batch-forming code on the caller's thread.

Differences from the reference: with ``bench=None`` no file is read (no
caps: every spec coalesces to ``serve_max_batch``); the width handed to
the worker is given by its shape alone (zero-stride host arrays), so
handing it over copies nothing to the device; on the card a width is
warm only once captured (and warm at once if the executor captured it
before), a batch pads at most 4-fold, and it may run as a few calls at
a smaller warm width (counted in ``width_fallbacks``; its event's width
is the rows the calls ran).
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.executor import Executor, _pad_rows, _tree
from repro_torch.core.plan import (CircleQuery, EngineConfig, InsertBatch,
                                   Knn, PointQuery, QuerySpec, RangeCount,
                                   RangeQuery, SpatialJoin, UpdateSpec)


def bench_spec_name(spec: QuerySpec) -> str:
    """The benchmark record's spec-column name for a QuerySpec."""
    if isinstance(spec, PointQuery):
        return "point"
    if isinstance(spec, RangeCount):
        return "range_count"
    if isinstance(spec, RangeQuery):
        return "range"
    if isinstance(spec, CircleQuery):
        return "circle_mat" if spec.materialize else "circle"
    if isinstance(spec, Knn):
        return f"knn{spec.k}"
    if isinstance(spec, SpatialJoin):
        return "join"
    return spec.kind


def micro_batch_caps(bench: Union[str, dict, None], backend: str,
                     cfg: EngineConfig) -> dict:
    """Per-spec micro-batch caps from a benchmark record's wide-batch
    columns (a dict, or the path of a JSON file).

    A spec with both ``steady_us_per_q`` (narrow) and
    ``steady_us_per_q_b256`` (wide) measured coalesces up to the
    record's wide batch (``bench_q_wide``; the caller clamps it to
    ``cfg.serve_max_batch``): the tier-bucketed wide dispatch makes the
    wide column no slower per query for every spec. The record's
    ``backends[backend]`` section is read when it has one. No record, no
    file or no columns -> an empty dict (callers default to
    serve_max_batch)."""
    if isinstance(bench, str):
        try:
            with open(bench) as f:
                bench = json.load(f)
        except (OSError, ValueError):
            return {}
    if not isinstance(bench, dict):
        return {}
    br = (bench.get("backends") or {}).get(backend) or bench
    wide_b = int(bench.get("bench_q_wide", cfg.serve_max_batch))
    caps = {}
    for name, s in (br.get("specs") or {}).items():
        if (s.get("steady_us_per_q") is None
                or s.get("steady_us_per_q_b256") is None):
            continue
        caps[name] = wide_b
    return caps


# on the card: the most replays a batch is cut into at a smaller warm
# width (``SpatialScheduler._chunk_rows``), and the most a batch is
# padded at a larger one (``_pick_width``)
_MAX_CHUNKS = 4


def _bucket(n: int) -> int:
    """Next power-of-two batch width."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _dtype_name(a) -> str:
    """A numpy array's or a tensor's dtype by one name ("float32" for
    both ``np.float32`` and ``torch.float32``), so the two coalesce."""
    return str(a.dtype).removeprefix("torch.")


def _shaped(sig, width: int) -> tuple:
    """Stand-ins for a batch of coalescing signature ``sig`` padded to
    ``width`` rows: zero-stride host arrays of its shapes and dtypes
    (the executor reads only those)."""
    return tuple(np.broadcast_to(np.zeros((), np.dtype(d)),
                                 (width,) + tuple(shape))
                 for shape, d in sig[1:])


class Ticket:
    """Future for one scheduled request.

    ``result()`` blocks until the micro-batch that carried the request
    completed on the device. After completion:

      ``epoch``    the index mutation epoch the request observed (reads)
                   or produced (writes): the read-your-writes token;
      ``batched``  the coalesced query width of the dispatch it rode in.
    """

    __slots__ = ("spec", "epoch", "batched", "_done", "_result", "_exc")

    def __init__(self, spec):
        self.spec = spec
        self.epoch: Optional[int] = None
        self.batched = 0
        self._done = threading.Event()
        self._result = None
        self._exc = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.spec!r} not completed "
                               f"within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _resolve(self, result, epoch: int, batched: int):
        self._result = result
        self.epoch = epoch
        self.batched = batched
        self._done.set()

    def _fail(self, exc: BaseException):
        self._exc = exc
        self._done.set()


class _Request:
    __slots__ = ("kind", "spec", "args", "qlen", "sig", "ticket")

    def __init__(self, kind, spec, args, qlen, sig, ticket):
        self.kind = kind          # "read" | "write" | "maintain"
        self.spec = spec
        self.args = args
        self.qlen = qlen
        self.sig = sig
        self.ticket = ticket


class SpatialScheduler:
    """Queue + batch former + worker over one (locked) Executor.

    ``bench``: a benchmark record (dict or JSON path) for the per-spec
    caps, or None for none; ``start=False``: no worker thread, the
    caller pumps ``drain()``. ``stats()`` has the reference's keys; the
    worker's failed captures are the executor's
    ``stats()["async_capture_errors"]``."""

    def __init__(self, executor: Executor,
                 bench: Union[str, dict, None] = None,
                 start: bool = True):
        mesh = getattr(executor, "mesh", None)
        if mesh is not None and mesh.size > 1:
            # a single controller forms one batch for every device; here
            # each rank would form its own from its own thread timing,
            # and the ranks' collectives would not meet
            raise ValueError(f"SpatialScheduler cannot serve a mesh of "
                             f"{mesh.size} ranks: its batches follow thread "
                             "timing, which differs from rank to rank")
        self.ex = executor
        self.cfg = executor.cfg
        self.caps = micro_batch_caps(bench, executor.backend.name,
                                     self.cfg)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stopping = False
        self._inflight = 0        # popped but not yet resolved
        self.events: deque = deque(maxlen=4096)
        self.submitted = 0
        self.reads = 0            # queries dispatched via read batches
        self.read_batches = 0     # coalesced read dispatches
        self.max_batch = 0        # widest coalesced read batch (queries)
        self.writes = 0           # write requests applied
        self.write_merges = 0     # insert requests merged into a run
        self.maintain_runs = 0
        self.maintain_busy = 0    # maintain with a non-empty queue (BAD)
        # -- the warm-width handoff (DESIGN.md §14) -------------------------
        self.width_fallbacks = 0  # dispatches at a warm width not the
                                  # batch's own: a larger one, or on the
                                  # card a few calls at a smaller one
        self._warm = {}           # coalescing sig -> warm pow2 widths
        self._warm_epoch = executor.index.shape_epoch
        self._pc_pending = {}     # (sig, width) -> precompile label
        self._pc_started = False
        self._thread = None
        if start:
            if self.cfg.serve_async_precompile:
                # worker mode only: drain() mode stays deterministic
                self._pc_started = executor.start_precompiler()
            self._thread = threading.Thread(
                target=self._worker, daemon=True,
                name="spatial-serve-scheduler")
            self._thread.start()

    # -- submission ------------------------------------------------------

    def submit(self, spec: QuerySpec, *args) -> Ticket:
        """Enqueue one request; returns at once with its Ticket."""
        if not isinstance(spec, QuerySpec):
            raise TypeError(f"expected a QuerySpec, got {spec!r}")
        if len(args) != spec.n_args:
            raise TypeError(f"{type(spec).__name__} takes {spec.n_args} "
                            f"data arguments, got {len(args)}")
        args = tuple(a if hasattr(a, "shape") else np.asarray(a)
                     for a in args)
        qlen = int(args[0].shape[0]) if args else 0
        # coalescing signature: same spec (frozen dataclass equality ==
        # same program family) AND concat-compatible trailing shapes
        sig = (spec,) + tuple((tuple(a.shape[1:]), _dtype_name(a))
                              for a in args)
        kind = "write" if isinstance(spec, UpdateSpec) else "read"
        ticket = Ticket(spec)
        req = _Request(kind, spec, args, qlen, sig, ticket)
        with self._cv:
            if self._stopping:
                raise RuntimeError("scheduler is closed")
            while (self._thread is not None
                   and len(self._q) >= self.cfg.serve_queue_depth):
                self._cv.wait(0.005)     # backpressure
                if self._stopping:
                    raise RuntimeError("scheduler is closed")
            self._q.append(req)
            self.submitted += 1
            self._cv.notify_all()
        return ticket

    def request_maintain(self) -> Ticket:
        """Enqueue an explicit maintenance barrier (in arrival order,
        after everything already queued). Resolves with maintain()'s
        {moved} dict."""
        ticket = Ticket(None)
        with self._cv:
            if self._stopping:
                raise RuntimeError("scheduler is closed")
            self._q.append(_Request("maintain", None, (), 0, None,
                                    ticket))
            self.submitted += 1
            self._cv.notify_all()
        return ticket

    # -- batch forming ---------------------------------------------------

    def _cap(self, spec: QuerySpec) -> int:
        cap = self.caps.get(bench_spec_name(spec),
                            self.cfg.serve_max_batch)
        return max(1, min(self.cfg.serve_max_batch, cap))

    def _pick_width(self, reqs, total: int) -> int:
        """Batch width for a read dispatch. Default: the power-of-two
        bucket. While the executor's precompile worker runs and this
        (sig, bucket) is not warm yet, hand the width to the worker and
        dispatch at the nearest LARGER warm width instead (extra row-0
        padding is bitwise neutral: each ticket slices only its own
        rows). Once the worker reports the width done, later batches
        take it."""
        width = _bucket(total)
        if not self.ex.precompiling:
            return width
        self._check_epoch()
        pend = self._pc_pending
        for k in [k for k, lbl in pend.items()
                  if self.ex.precompile_done(lbl)]:
            self._warm.setdefault(k[0], set()).add(k[1])
            del pend[k]
        sig = reqs[0].sig
        warm = self._warm.get(sig)
        if warm is None:
            warm = self._warm[sig] = self._captured_widths(sig)
        if width in warm:
            return width
        if (sig, width) not in pend:
            label = self.ex.precompile_async(reqs[0].spec,
                                             *_shaped(sig, width))
            if label is not None:
                pend[(sig, width)] = label
        bigger = [w for w in warm if w > width]
        if self.ex.cuda_graphs:
            # on the card padding multiplies the fused programs' device
            # work (and from tier_bucket_min on adds the bucketed
            # dispatch's host read): pad at most _MAX_CHUNKS-fold, else
            # run in chunks of a smaller warm width (_chunk_rows)
            bigger = [w for w in bigger if w <= _MAX_CHUNKS * width]
        if bigger:
            self.width_fallbacks += 1
            return min(bigger)
        return width                     # nothing warm above: as it is

    def _captured_widths(self, sig) -> set:
        """On the card, the power-of-two widths of ``sig`` whose graphs
        the executor already holds (captured before this scheduler
        started, by serial submits or an earlier scheduler), so a new
        scheduler pads or chunks to them from its first batch. On the
        CPU none: a width is warm once dispatched, as in the
        reference."""
        if not self.ex.cuda_graphs:
            return set()
        out, w = set(), 1
        while w <= self.cfg.serve_max_batch:
            if self.ex.warm_for(sig[0], *_shaped(sig, w)):
                out.add(w)
            w *= 2
        return out

    def _chunk_rows(self, sig, width: int) -> Optional[int]:
        """On the card, for a batch whose width is not warm and that no
        warm width up to ``_MAX_CHUNKS``-fold larger holds (``_pick_width``
        pads to those): the largest warm width below it, when
        at most ``_MAX_CHUNKS`` calls at it cover the batch; else None.
        There the executor runs a width eagerly until the worker has
        captured it, and an eager run costs about as much host time as
        the capture the worker avoids, so the batch runs as a few
        replays instead (``Executor.run_rows``: bitwise one call). On
        the CPU a dispatch realizes its width at once, as the
        reference's compile does: no chunks there."""
        if not (self.ex.precompiling and self.ex.cuda_graphs):
            return None
        warm = self._warm.get(sig, ())
        if width in warm or any(width < w <= _MAX_CHUNKS * width
                                for w in warm):
            return None
        smaller = [w for w in warm if w < width]
        if not smaller or width > _MAX_CHUNKS * max(smaller):
            return None
        self.width_fallbacks += 1
        return max(smaller)

    def _check_epoch(self) -> None:
        """A shape-epoch bump evicted the programs: forget every warm
        width and pending label."""
        se = self.ex.index.shape_epoch
        if se != self._warm_epoch:
            self._warm.clear()
            self._pc_pending.clear()
            self._warm_epoch = se

    def _mark_warm(self, sig, width: int) -> None:
        """After a dispatch at ``width``: the width is warm if the
        dispatch ran finished realizations (``Executor.warm_for``)."""
        if not self.ex.precompiling:
            return
        self._check_epoch()
        if self.ex.warm_for(sig[0], *_shaped(sig, width)):
            self._warm.setdefault(sig, set()).add(width)

    def _pop(self, timeout: Optional[float] = None):
        with self._cv:
            if not self._q and timeout:
                self._cv.wait(timeout)
            if self._q:
                self._inflight += 1
                self._cv.notify_all()    # free a backpressured submit
                return self._q.popleft()
            return None

    def _pop_merge(self, req: _Request, total: int):
        """Pop the next queued item iff it merges with an InsertBatch
        run: same spec and signature, and the merged width stays within
        serve_max_batch."""
        with self._cv:
            if (self._q and self._q[0].kind == "write"
                    and self._q[0].sig == req.sig
                    and total + self._q[0].qlen
                    <= self.cfg.serve_max_batch):
                self._inflight += 1
                self._cv.notify_all()
                return self._q.popleft()
        return None

    def _finish(self, n: int):
        with self._cv:
            self._inflight -= n
            self._cv.notify_all()

    def _form_and_run(self, straggler_wait: float = 0.0) -> bool:
        """Drain the queue once: FIFO order, reads coalesced between
        write barriers. Returns whether any request was processed."""
        groups: "OrderedDict[tuple, list]" = OrderedDict()
        sizes: dict = {}
        did = False

        def flush(sig):
            reqs = groups.pop(sig)
            sizes.pop(sig)
            self._dispatch_reads(reqs)

        def flush_all():
            while groups:
                flush(next(iter(groups)))

        while True:
            req = self._pop()
            if req is None and groups and straggler_wait:
                # a partial batch exists: wait briefly for stragglers
                req = self._pop(timeout=straggler_wait)
            if req is None:
                break
            did = True
            if req.kind == "read":
                groups.setdefault(req.sig, []).append(req)
                sizes[req.sig] = sizes.get(req.sig, 0) + req.qlen
                if sizes[req.sig] >= self._cap(req.spec):
                    flush(req.sig)
            elif req.kind == "maintain":
                flush_all()              # barrier: order preserved
                self._maintain(ticket=req.ticket)
            else:
                flush_all()              # write barrier
                run, total = [req], req.qlen
                if isinstance(req.spec, InsertBatch):
                    while True:
                        nxt = self._pop_merge(req, total)
                        if nxt is None:
                            break
                        run.append(nxt)
                        total += nxt.qlen
                self._dispatch_write(run, total)
        flush_all()
        return did

    # -- dispatch --------------------------------------------------------

    def _cat(self, col) -> torch.Tensor:
        """One argument column of a batch on the executor's device: host
        arrays alone are concatenated on the host and copied once; a
        column holding a tensor is concatenated on the device."""
        dev = self.ex.device
        if not any(isinstance(a, torch.Tensor) for a in col):
            return torch.as_tensor(np.concatenate(col), device=dev)
        return torch.cat([a.to(dev) if isinstance(a, torch.Tensor)
                          else torch.as_tensor(np.asarray(a), device=dev)
                          for a in col])

    def _concat_pad(self, reqs, width: int):
        """Concat request args along the query axis; pad to ``width`` by
        repeating row 0 (a real, resolvable query: it can never trip the
        adaptive ok flags). Tickets slice only their own rows, so ANY
        width >= the total is bitwise-equivalent."""
        args = tuple(self._cat(c) for c in zip(*(r.args for r in reqs)))
        pad = width - int(args[0].shape[0]) if args else 0
        if pad > 0:
            args = _pad_rows(args, pad)
        return args

    def _device_done(self):
        """Wait, on this thread, until the work queued so far on the
        executor's stream completed (a CUDA event); nothing on the
        CPU."""
        if self.ex.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.ex.device))
            ev.synchronize()

    def _dispatch_reads(self, reqs):
        spec = reqs[0].spec
        total = sum(r.qlen for r in reqs)
        try:
            width = self._pick_width(reqs, total)
            rows = self._chunk_rows(reqs[0].sig, width)
            if rows is not None:           # a few replays at a warm width
                width = -(-total // rows) * rows
            pad = width - total
            whole = len(reqs) == 1 and pad == 0 and rows is None
            args = reqs[0].args if whole else self._concat_pad(reqs, width)
            if rows is None:
                out = self.ex.run(spec, *args)
            else:
                out = self.ex.run_rows(spec, *args, rows=rows)
            self._device_done()
        except Exception as e:           # route the failure per request
            for r in reqs:
                r.ticket._fail(e)
            self._finish(len(reqs))
            return
        epoch = self.ex.epoch
        lo = 0
        for r in reqs:
            if whole:
                res = out
            else:
                hi = lo + r.qlen
                res = _tree(lambda a: a[lo:hi], out)
            r.ticket._resolve(res, epoch, total)
            lo += r.qlen
        self.reads += total
        self.read_batches += 1
        self.max_batch = max(self.max_batch, total)
        if rows is None:
            self._mark_warm(reqs[0].sig, width)
        self.events.append(("batch", bench_spec_name(spec), total,
                            width, len(reqs)))
        self._finish(len(reqs))

    def _dispatch_write(self, run, total):
        spec = run[0].spec
        try:
            if len(run) == 1:
                out = self.ex.run(spec, *run[0].args)
            else:                        # merged InsertBatch stream
                xs = self._cat([r.args[0] for r in run])
                ys = self._cat([r.args[1] for r in run])
                out = self.ex.run(spec, xs, ys)
                self.write_merges += len(run) - 1
            self._device_done()
        except Exception as e:
            for r in run:
                r.ticket._fail(e)
            self._finish(len(run))
            return
        epoch = self.ex.epoch            # the epoch this write produced
        lo = 0
        for r in run:
            res = out if len(run) == 1 else out[lo:lo + r.qlen]
            r.ticket._resolve(res, epoch, total)
            lo += r.qlen
        self.writes += len(run)
        self.events.append(("write", spec.kind, total, len(run)))
        self._finish(len(run))

    def _maintain(self, ticket: Optional[Ticket] = None,
                  idle: bool = False):
        with self._cv:
            qlen = len(self._q)
        try:
            moved = self.ex.maintain()
        except Exception as e:
            if ticket is None:
                raise
            ticket._fail(e)
            self._finish(1)
            return
        self.maintain_runs += 1
        if qlen:
            self.maintain_busy += 1      # should never happen on idle
        self.events.append(("maintain", qlen, bool(moved), idle))
        if ticket is not None:
            ticket._resolve(moved, self.ex.epoch, 0)
            self._finish(1)

    # -- worker / pumping ------------------------------------------------

    def _worker(self):
        straggler = self.cfg.serve_coalesce_us / 1e6
        while True:
            with self._cv:
                while not self._q and not self._stopping:
                    self._cv.wait(0.05)
                if self._stopping and not self._q:
                    return
            self._form_and_run(straggler_wait=straggler)
            # idle maintenance: the queue just drained; run deferred
            # re-tuning / re-fits NOW, never between queued requests
            with self._cv:
                idle = not self._q and not self._stopping
            if (idle and self.cfg.serve_idle_maintain
                    and self.ex.maintenance_due()):
                self._maintain(idle=True)

    def drain(self, timeout: float = 60.0):
        """Process everything queued. With start=False this runs the
        batch former on the calling thread (then idle maintenance): the
        deterministic mode. With a live worker it blocks until the queue
        and the in-flight work are empty."""
        if self._thread is not None:
            deadline = time.monotonic() + timeout
            while True:
                with self._cv:
                    if not self._q and self._inflight == 0:
                        return
                    self._cv.wait(0.005)
                if time.monotonic() > deadline:
                    raise TimeoutError("scheduler drain timed out")
        self._form_and_run()
        if self.cfg.serve_idle_maintain and self.ex.maintenance_due():
            self._maintain(idle=True)

    def close(self):
        """Stop accepting requests, flush the queue, join the worker."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        else:
            self._form_and_run()         # flush manual-mode leftovers
        if self._pc_started:
            self.ex.stop_precompiler()
            self._pc_started = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        with self._cv:
            qlen, inflight = len(self._q), self._inflight
        return {
            "submitted": self.submitted,
            "queue_len": qlen,
            "inflight": inflight,
            "reads": self.reads,
            "read_batches": self.read_batches,
            "mean_batch": round(self.reads / max(self.read_batches, 1),
                                2),
            "max_batch": self.max_batch,
            "writes": self.writes,
            "write_merges": self.write_merges,
            "maintain_runs": self.maintain_runs,
            "maintain_busy": self.maintain_busy,
            "width_fallbacks": self.width_fallbacks,
            "precompile_pending": len(self._pc_pending),
            "caps": dict(self.caps),
            "epoch": self.ex.epoch,
        }
