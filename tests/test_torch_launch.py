"""The port's launchers run to the end on the CPU at a tiny size:
``repro_torch.launch.spatial`` and ``repro_torch.launch.serve --spatial``
with and without ``--scheduler``, and with ``--compile-cache``; the
serve launcher refuses the LM mode, and both run on the card by
default; the spatial launcher on a mesh of two gloo ranks."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve, spatial

# the suite runs in parallel worker processes: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--n", "20000"]


def test_spatial_launcher_runs_every_spec(capsys):
    spatial.main(TINY + ["--queries", "8", "--partitions", "16"])
    out = capsys.readouterr().out
    assert "backend=torch device=cpu" in out
    for name in ("point", "range_count", "range", "circle", "knn",
                 "join"):
        assert any(line.split()[0] == name and "us/query" in line
                   for line in out.splitlines()), name
    assert "host syncs total" in out and "cached executables" in out


def test_serve_rounds_after_warmup_add_no_host_sync(capsys):
    serve.main(["--spatial"] + TINY + ["--batch", "8", "--rounds", "2"])
    rounds = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("round ")]
    assert len(rounds) == 2
    assert all("(host_syncs +0, " in line for line in rounds), rounds
    # steady rounds realize no new program: the cache size holds
    caches = {line.split("cache ")[1] for line in rounds}
    assert len(caches) == 1, rounds


@pytest.mark.parametrize("run", [
    lambda d: spatial.main(TINY + ["--queries", "8", "--partitions", "16",
                                   "--compile-cache", d]),
    lambda d: serve.main(["--spatial"] + TINY + ["--batch", "8", "--rounds",
                                                 "1", "--compile-cache", d]),
], ids=["spatial", "serve"])
def test_launchers_take_a_compile_cache(run, tmp_path, capsys):
    """--compile-cache reaches EngineConfig: the store's directory is
    made (the CPU loads no kernel library, so it stays empty)."""
    cache = tmp_path / "cache"
    run(str(cache))
    assert "executables" in capsys.readouterr().out
    assert (cache / "entries").is_dir()


def test_serve_scheduler_runs_to_the_end(capsys):
    serve.main(["--spatial", "--scheduler"] + TINY +
               ["--batch", "8", "--rounds", "2"])
    out = capsys.readouterr().out
    assert "16 requests from 8 clients" in out and "req/s" in out
    assert "p50" in out and "p99" in out and "mean batch" in out
    assert "(0 busy)" in out


def test_spatial_launcher_on_a_mesh_of_two_ranks():
    """``--mesh host --query-shard`` under torch.distributed.run with two
    gloo ranks (a (1, 2) partition x query mesh): it runs to the end,
    shards the 8-query batches over the query axis, and only rank 0
    prints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "repro_torch.launch.spatial",
           "--mesh", "host", "--query-shard", "--query-shard-threshold", "8",
           *TINY, "--queries", "8", "--partitions", "16"]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("generating ") for ln in lines) == 1, lines
    assert any("mesh={'data': 1, 'query': 2} query_axis=query" in ln
               for ln in lines), lines
    for name in ("point", "range_count", "range", "circle", "knn", "join"):
        assert sum(ln.split()[:1] == [name] and "us/query" in ln
                   for ln in lines) == 1, name
    final = [ln for ln in lines if "qshard_executables=" in ln]
    assert len(final) == 1 and not final[0].endswith("=0"), final


def test_serve_without_spatial_exits_non_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "item 19" in out.stderr


@pytest.mark.parametrize("run", [
    lambda: spatial.main(["--n", "2000", "--queries", "8"]),
    lambda: serve.main(["--spatial", "--n", "2000", "--batch", "8"]),
    lambda: serve.main(["--spatial", "--scheduler", "--n", "2000"]),
], ids=["spatial", "serve", "serve_scheduler"])
def test_launchers_default_to_the_card(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        run()
