"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled on
first use, for ``sm_90a`` (Hopper), into its own shared library under
``build/repro_torch/`` at the repository root. A library's file name
carries a hash of its source, so an edited source is rebuilt and never
confused with a stale build. ``build_all`` starts one ``nvcc`` per
source, all at once.

This module is imported only when a kernel is first launched on a CUDA
tensor: the package imports, and its CPU tests run, without ``nvcc``.
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


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temp file; None if built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builds agree


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel source in parallel.

    Returns {name: library path}."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is not None:
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in names}


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
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signature.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} "
                           f"(cudaError {err})")
