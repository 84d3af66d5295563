"""Kernel launch counts that stay exact under threads.

Each kernel module keeps ``launches``, the number of times its wrapper
launched its kernel. A wrapper counts through ``count(__name__)``: the
module's count goes up by one under a lock (a bare ``+=`` from two
threads can lose an update), unless the calling thread is capturing a
CUDA graph, in which case the launch goes to that thread's ``tally``.
A capture launches nothing: the graph adds its tally with ``add`` each
time it replays.
"""
from __future__ import annotations

import sys
import threading
from contextlib import contextmanager

_lock = threading.Lock()
_local = threading.local()


def count(module: str) -> None:
    """One launch of the kernel of ``module`` (a module name)."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[module] = tally.get(module, 0) + 1
        return
    with _lock:
        sys.modules[module].launches += 1


def add(counts: dict) -> None:
    """Add {module name: launches} to the modules' counts."""
    if not counts:
        return
    with _lock:
        for module, n in counts.items():
            sys.modules[module].launches += n


def read(modules) -> dict:
    """{module name: launches} of ``modules``, read together."""
    with _lock:
        return {m.__name__: m.launches for m in modules}


def reset(modules) -> None:
    with _lock:
        for m in modules:
            m.launches = 0


@contextmanager
def tally():
    """While open, this thread's launches go to the yielded dict
    {module name: launches} and not to the modules' counts."""
    prev = getattr(_local, "tally", None)
    own = {}
    _local.tally = own
    try:
        yield own
    finally:
        _local.tally = prev
