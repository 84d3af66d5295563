"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled on
first use, for ``sm_90a`` (Hopper), into its own shared library under
``build/repro_torch/`` at the repository root. A library's file name
carries a hash of its source, so an edited source is rebuilt and never
confused with a stale build. ``build_all`` starts one ``nvcc`` per
source, all at once.

With a store (``use_store``: the executor passes the on-disk store of
``EngineConfig.compile_cache_dir``, core/compile_cache.CompileCache),
the store is the build directory: each library is built into, and
loaded from, its entry ``entries/<fp>.bin``, fp the fingerprint of (the
store's process context, ``("kernel", name)``, ``source_hash``). A
library found there is a hit and runs no ``nvcc``; one that does not
load is invalidated, rebuilt in its place and counted as a miss. The
store's LRU keeps its entries under its byte cap.

This module is imported only when a kernel is first launched on a CUDA
tensor, or an executor is given a store: the package imports, and its
CPU tests run, without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}          # kernel name -> loaded ctypes.CDLL
# the store and its counters: process-level, like the loaded libraries
# (every executor with a cache directory reads the same ones)
_store = None             # use_store's store, or None
_looked_up: dict = {}     # name -> True (a store hit) or False (a miss)
disk_hits = 0             # libraries found in the store, once each
disk_misses = 0           # libraries the store lacked or held unusable
compiles = 0              # nvcc compiles this process started


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def source_hash(name: str) -> str:
    """sha256 of ``name``'s source, every header and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _fingerprint(store, name: str) -> str:
    return store.fingerprint(("kernel", name), (source_hash(name),))


def _lib_path(store, name: str) -> Path:
    if store is not None:
        return store.path(_fingerprint(store, name))
    return BUILD_DIR / f"lib{name}-{source_hash(name)[:16]}.so"


def lib_path(name: str) -> Path:
    """Where ``name``'s library is built: its store entry, or the build
    directory without a store."""
    return _lib_path(_store, name)


def use_store(store) -> None:
    """Build and load the kernel libraries in ``store`` (None: the build
    directory). The store is process-level, like the libraries: the last
    executor given a cache directory sets it, and libraries already
    loaded stay."""
    global _store
    with _lock:
        _store = store


def _start(name: str, out: Path):
    """Start nvcc for one source into a temp file beside ``out``."""
    global compiles
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=out.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    compiles += 1
    return proc, tmp, out


def _finish(name: str, started, store) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builds agree
    if store is not None:
        store.admit(out.stem, {"key": ["kernel", name]})


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel source that is not built yet,
    in parallel. Returns {name: library path}."""
    global disk_hits, disk_misses
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    store = _store
    paths = {n: _lib_path(store, n) for n in names}
    started = {}
    for n, out in paths.items():
        first = store is not None and n not in _looked_up
        if not out.exists():
            disk_misses += first
            if first:
                _looked_up[n] = False
            started[n] = _start(n, out)
        elif first:
            disk_hits += 1
            _looked_up[n] = True
            store.touch(out.stem)
    errors = []
    for n, s in started.items():
        try:
            _finish(n, s, store)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) of the
    last build of ``name``, or '' when it was not built here."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str, signature: dict) -> ctypes.CDLL:
    """Load (building first if needed) the library of ``name`` and set
    the argument and return types of its functions from ``signature``
    ({function: [ctypes types]}). Every function returns the int that
    ``cudaGetLastError()`` gave after its launch."""
    global disk_hits, disk_misses
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            store = _store
            path = build_all([name])[name]
            try:
                lib = _open(path, signature)
            except (OSError, AttributeError):
                if store is None or not _looked_up.get(name):
                    raise
                # the stored library does not load: drop it and rebuild
                # it in its place, counted as a miss
                _looked_up[name] = False
                store.invalidate(path.stem)
                disk_hits -= 1
                disk_misses += 1
                _finish(name, _start(name, path), store)
                lib = _open(path, signature)
            _libs[name] = lib
        return lib


def _open(path: Path, signature: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signature.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} "
                           f"(cudaError {err})")
