"""Warm start's on-disk store (DESIGN.md §14).

Two layers take a restarted process to the steady path:

  program layer  in memory only: the executor's program cache
                 (core/executor.py ``_Dispatch``), one CUDA graph per
                 (exec_key, argument signature) on the card. A CUDA
                 graph cannot be serialized, so a new process captures
                 its graphs again; ``Executor.manifest()`` records which,
                 and ``prewarm()`` captures them before traffic.
  disk layer     this module: the CUDA kernel libraries that
                 kernels/_build.py compiles with nvcc straight into the
                 store, content-addressed by ``plan.cache_fingerprint``
                 of (``process_context()``, ``("kernel", name)``,
                 ``_build.source_hash`` of the source, headers and flags)
                 under ``<root>/entries/<fp>.bin``, and loads from there.
                 A hit loads the library without running nvcc.

Entries land through a temp file and ``os.replace``, so a reader never
sees a torn write, and any failure (a corrupt entry, a version drift, an
unwritable directory) degrades to a fresh build: the store is an
accelerator, never a correctness dependency. The library counters are
kernels/_build's (``disk_hits``, ``disk_misses``); ``hits`` and
``misses`` here count ``load``'s blob reads.

Layout under ``EngineConfig.compile_cache_dir``:

    entries/<sha256>.bin   one stored entry (a kernel library, loadable
                           in place)
    manifest.json          informational: fp -> {key, size, created}
                           (best-effort; losing it costs nothing, the
                           entries are content-addressed)
    prewarm.json           optional Executor.manifest() snapshot for
                           manifest-driven prewarm across restarts

Eviction is size-capped LRU by mtime: ``load`` and ``touch`` bump the
entry's mtime, ``store`` and ``admit`` trigger a sweep deleting
oldest-first until the entries/ tree fits
``EngineConfig.compile_cache_bytes``.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core import plan

__all__ = ["CompileCache", "process_context", "save_manifest",
           "load_manifest"]

_NVCC_LINE: dict = {}     # nvcc path -> its version line (one run each)


def _nvcc_line() -> str:
    """The last line of ``nvcc --version`` (its build), or "none"."""
    from repro_torch.kernels import _build
    try:
        path = _build.nvcc()
    except RuntimeError:
        return "none"
    if path not in _NVCC_LINE:
        try:
            out = subprocess.run([path, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
            _NVCC_LINE[path] = out.strip().splitlines()[-1]
        except (OSError, IndexError, subprocess.SubprocessError):
            _NVCC_LINE[path] = "none"
    return _NVCC_LINE[path]


def process_context(device="cuda") -> dict:
    """Process-level invariants folded into every fingerprint: an entry
    is only reachable from an environment that would have built the
    same one. On the CPU the device fields read "cpu"."""
    dev = torch.device(device)
    ctx = {"schema": plan.CACHE_SCHEMA, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if dev.type != "cuda":
        return dict(ctx, nvcc="cpu", device="cpu", capability="cpu",
                    device_count=0)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(ctx, nvcc=_nvcc_line(),
                device=torch.cuda.get_device_name(idx),
                capability=list(torch.cuda.get_device_capability(idx)),
                device_count=torch.cuda.device_count())


def save_manifest(path, manifest: dict) -> None:
    """Atomic JSON write of an Executor.manifest() snapshot."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, str(path))
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_manifest(path) -> Optional[dict]:
    """Read a prewarm manifest; None if missing or unreadable."""
    try:
        with open(path) as f:
            m = json.load(f)
        return m if isinstance(m, dict) else None
    except (OSError, ValueError):
        return None


class CompileCache:
    """Content-addressed blob store.

    Thread-safe: the atomic-replace protocol makes racing stores of the
    same fingerprint idempotent (both write identical bytes).
    """

    def __init__(self, root, max_bytes: int = 1 << 30,
                 context: Optional[dict] = None):
        self.root = Path(root)
        self.entries = self.root / "entries"
        self.entries.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.context = dict(context or {})
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- addressing ---------------------------------------------------

    def fingerprint(self, key: Tuple, args_sig: Tuple) -> str:
        return plan.cache_fingerprint(self.context, key, args_sig)

    def path(self, fp: str) -> Path:
        return self.entries / f"{fp}.bin"

    # -- blob I/O -----------------------------------------------------

    def load(self, fp: str) -> Optional[bytes]:
        """The stored bytes, or None (miss). Bumps mtime (LRU)."""
        p = self.path(fp)
        try:
            data = p.read_bytes()
        except OSError:
            with self._lock:
                self.misses += 1
            return None
        try:
            os.utime(p)
        except OSError:
            pass
        with self._lock:
            self.hits += 1
        return data

    def store(self, fp: str, data: bytes, meta: Optional[dict] = None
              ) -> bool:
        """Atomically persist one entry; best-effort (False on any I/O
        failure)."""
        p = self.path(fp)
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.entries),
                                       suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, str(p))
        except OSError:
            try:
                os.unlink(tmp)
            except (OSError, UnboundLocalError):
                pass
            return False
        if meta is not None:
            self._note(fp, dict(meta, size=len(data)))
        self.evict()
        return True

    def admit(self, fp: str, meta: Optional[dict] = None) -> None:
        """Record an entry its producer wrote in place (through a temp
        file and ``os.replace``, as nvcc's library is) and sweep."""
        if meta is not None:
            try:
                size = self.path(fp).stat().st_size
            except OSError:
                return
            self._note(fp, dict(meta, size=size))
        self.evict()

    def touch(self, fp: str) -> None:
        """Mark an entry used without reading it (LRU)."""
        try:
            os.utime(self.path(fp))
        except OSError:
            pass

    def invalidate(self, fp: str) -> None:
        """Drop a corrupt or unloadable entry so the next process
        rebuilds instead of tripping on it again."""
        try:
            os.unlink(self.path(fp))
        except OSError:
            pass

    # -- hygiene ------------------------------------------------------

    def evict(self, max_bytes: Optional[int] = None) -> int:
        """Size-capped LRU-by-mtime sweep of entries/. Returns the
        number of entries deleted."""
        cap = self.max_bytes if max_bytes is None else int(max_bytes)
        try:
            ents = [(p.stat().st_mtime, p.stat().st_size, p)
                    for p in self.entries.glob("*.bin")]
        except OSError:
            return 0
        total = sum(s for _, s, _ in ents)
        if total <= cap:
            return 0
        dropped = 0
        for _, size, p in sorted(ents):        # oldest mtime first
            if total <= cap:
                break
            try:
                p.unlink()
            except OSError:
                continue
            total -= size
            dropped += 1
        return dropped

    def size_bytes(self) -> int:
        try:
            return sum(p.stat().st_size
                       for p in self.entries.glob("*.bin"))
        except OSError:
            return 0

    def __len__(self) -> int:
        try:
            return sum(1 for _ in self.entries.glob("*.bin"))
        except OSError:
            return 0

    # -- informational manifest ---------------------------------------

    def _note(self, fp: str, meta: dict) -> None:
        """Best-effort manifest.json update (atomic replace). Purely
        informational: the store is content-addressed."""
        mpath = self.root / "manifest.json"
        with self._lock:
            try:
                try:
                    with open(mpath) as f:
                        man = json.load(f)
                    if not isinstance(man, dict):
                        man = {}
                except (OSError, ValueError):
                    man = {}
                man[fp] = dict(meta, created=round(time.time(), 3))
                fd, tmp = tempfile.mkstemp(dir=str(self.root),
                                           suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump(man, f, indent=1, sort_keys=True)
                os.replace(tmp, str(mpath))
            except OSError:
                pass
