"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card unless told otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_statement(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_scan_covers_this_slice():
    """The import scan above sees the modules of the circle and join
    path, of serving mode, of the morton kernel, of the serve scheduler,
    of the launchers, of warm start's store and of the mesh."""
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"kernels/circle_filter.py", "kernels/point_in_polygon.py",
            "kernels/morton.py", "core/executor.py", "core/local_ops.py",
            "core/queries.py", "core/keys.py", "core/plan.py",
            "core/engine.py", "data/spatial.py", "serve/__init__.py",
            "serve/spatial.py", "serve/scheduler.py", "launch/__init__.py",
            "launch/spatial.py", "launch/serve.py", "launch/mesh.py",
            "core/compile_cache.py"} <= scanned


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.convert, repro_torch.data.spatial\n"
        "import repro_torch.core.backends, repro_torch.kernels._build\n"
        "import repro_torch.kernels.circle_filter\n"
        "import repro_torch.kernels.point_in_polygon\n"
        "import repro_torch.kernels.morton, repro_torch.serve.spatial\n"
        "import repro_torch.core.executor, repro_torch.core.local_ops\n"
        "import repro_torch.core.queries, repro_torch.core.keys\n"
        "import repro_torch.serve.scheduler, repro_torch.launch.spatial\n"
        "import repro_torch.launch.serve, repro_torch.core.compile_cache\n"
        "import repro_torch.launch.mesh\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch import convert
    from repro_torch.core import Executor, SpatialEngine, build_index, fit

    x = np.random.default_rng(0).random(500).astype(np.float32)
    part = fit("kdtree", x, x, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        build_index(x, x, part)
    idx = build_index(x, x, part, device="cpu")
    from repro_torch.serve import SpatialServeSession
    for make in (lambda: SpatialEngine(idx), lambda: Executor(idx),
                 lambda: SpatialServeSession(idx),
                 lambda: idx.to("cuda"),
                 lambda: convert.index_from_arrays({})):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
