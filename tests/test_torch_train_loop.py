"""The port's fault-tolerant training loop, its launcher and the example
twin, on the CPU (the twin of tests/test_fault.py).

Within the port: a run crashed after step 8 and resumed from its
checkpoint gives the losses and parameters of the uninterrupted 12-step
run bitwise (synchronous and async checkpoints); the loss falls by more
than 0.5 on a repeated batch; the watchdog counts one straggler.

Across the packages, at float32 compute, both starting from one step-0
checkpoint of the same weights: the reference crashes after step 8 and
the port resumes from its checkpoint for steps 8-11, and the other way
round; each side's losses agree with the other package's uninterrupted
run within ``CROSS_RTOL``. A training checkpoint (params and an
``AdamWState``) written by either package loads in the other under the
reference's names (``opt/.step``, ``opt/.m/...``, ``opt/.v/...``).
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train as LT
from repro import checkpoint as RCK
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.models import build_model as ref_build
from repro.train import TrainLoopConfig as RefLoopConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import make_train_step as ref_make_train_step
from repro.train import train_loop as ref_train_loop
from repro.train.loop import InjectedCrash as RefCrash
from repro_torch import checkpoint as CK
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline, make_batch
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.common import tree_items
from repro_torch.train import (TrainLoopConfig, adamw_init, make_train_step,
                               train_loop)
from repro_torch.train import loop as L
from repro_torch.train.loop import InjectedCrash
from repro_torch.train.optimizer import AdamWState
from test_torch_lm_models import ref_weights

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# the loss of a step, one package against the other (float32 compute,
# 4 steps after a resume: summation orders only)
CROSS_RTOL = 1e-4
STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=20)


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = build_model(cfg)
    return cfg, model, make_train_step(model, donate=False, **STEP_KW)


def _run(cfg, model, step, ckpt, steps, crash_at=None, async_ckpt=False):
    pipe = TokenPipeline(cfg, 2, 32, seed=0, device="cpu")
    lc = TrainLoopConfig(steps=steps, ckpt_every=4, ckpt_dir=str(ckpt),
                         log_every=0, crash_at_step=crash_at,
                         async_ckpt=async_ckpt)
    return train_loop(model, step, pipe, lc, seed=0, log_fn=quiet)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_crash_and_resume_bit_exact(tiny, tmp_path, async_ckpt):
    cfg, model, step = tiny
    ref_params, ref_opt, ref_hist = _run(cfg, model, step, tmp_path / "a",
                                         12, async_ckpt=async_ckpt)
    with pytest.raises(InjectedCrash):
        _run(cfg, model, step, tmp_path / "b", 12, crash_at=8,
             async_ckpt=async_ckpt)
    assert CK.latest_step(str(tmp_path / "b")) == 8
    params, opt, hist = _run(cfg, model, step, tmp_path / "b", 12,
                             async_ckpt=async_ckpt)
    assert len(hist["loss"]) == 4                   # steps 8..11 only
    assert hist["loss"] == ref_hist["loss"][8:]
    for tree_a, tree_b in ((params, ref_params), (opt.m, ref_opt.m),
                           (opt.v, ref_opt.v)):
        for (path, a), (_, b) in zip(tree_items(tree_a), tree_items(tree_b)):
            assert torch.equal(a, b), path
    assert int(opt.step) == int(ref_opt.step) == 12


class _RepeatPipeline(TokenPipeline):
    """Same batch every step: the loss must drop as the model memorizes."""

    def __next__(self):
        return make_batch(self.cfg, self.batch, self.seq, self.seed, 0,
                          device=self.device)


def test_loss_decreases(tiny):
    cfg, model, step = tiny
    pipe = _RepeatPipeline(cfg, 2, 32, seed=0, device="cpu")
    lc = TrainLoopConfig(steps=30, ckpt_dir=None, log_every=0)
    _, _, hist = train_loop(model, step, pipe, lc, seed=1, log_fn=quiet)
    first = np.mean(hist["loss"][:5])
    last = np.mean(hist["loss"][-5:])
    assert last < first - 0.5, (first, last)


def test_watchdog_counts_stragglers(tiny, monkeypatch):
    cfg, model, step = tiny
    times = iter([0.0, 0.1,    # step 0: 100ms
                  1.0, 1.1,    # step 1: 100ms
                  2.0, 2.1,    # step 2
                  3.0, 4.9])   # step 3: 1.9s -> straggler
    monkeypatch.setattr(L.time, "perf_counter", lambda: next(times))
    pipe = TokenPipeline(cfg, 2, 32, seed=0, device="cpu")
    lc = TrainLoopConfig(steps=4, ckpt_dir=None, log_every=0,
                         straggler_factor=3.0)
    logged = []
    _, _, hist = train_loop(model, step, pipe, lc, seed=0,
                            log_fn=logged.append)
    assert hist["stragglers"] == 1
    assert [m for m in logged if m.startswith("[watchdog] straggler step 3")]


# -- across the packages --------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both packages' float32 qwen smoke model, step and loop pieces, a
    step-0 checkpoint of the same weights (written by the reference),
    and each package's uninterrupted 12-step losses from it."""
    rc, pc = LT.configs("qwen2_5_3b", "float32")
    jp, _ = ref_weights(rc)
    root = tmp_path_factory.mktemp("cross")
    start = root / "start"
    RCK.save_checkpoint(str(start), 0, {"params": jp,
                                        "opt": ref_adamw_init(jp)})
    rm, pm = ref_build(rc), build_model(pc)
    side = {
        "ref": dict(cfg=rc, model=rm, step=ref_make_train_step(
            rm, donate=False, **STEP_KW)),
        "port": dict(cfg=pc, model=pm, step=make_train_step(
            pm, donate=False, **STEP_KW)),
    }

    def run(who, ckpt, crash_at=None):
        s = side[who]
        if who == "ref":
            pipe = RefPipeline(s["cfg"], 2, 32, seed=0)
            lc = RefLoopConfig(steps=12, ckpt_every=4, ckpt_dir=str(ckpt),
                               log_every=0, crash_at_step=crash_at,
                               async_ckpt=False)
            return ref_train_loop(s["model"], s["step"], pipe, lc,
                                  rng=jax.random.PRNGKey(0), log_fn=quiet)
        pipe = TokenPipeline(s["cfg"], 2, 32, seed=0, device="cpu")
        lc = TrainLoopConfig(steps=12, ckpt_every=4, ckpt_dir=str(ckpt),
                             log_every=0, crash_at_step=crash_at,
                             async_ckpt=False)
        return train_loop(s["model"], s["step"], pipe, lc, seed=0,
                          log_fn=quiet)

    full = {}
    for who in ("ref", "port"):
        d = root / f"full_{who}"
        shutil.copytree(start, d)
        full[who] = run(who, d)[2]["loss"]
    return {"root": root, "start": start, "run": run, "full": full}


@pytest.mark.parametrize("first,then", [("ref", "port"), ("port", "ref")])
def test_resume_across_packages(both, first, then):
    d = both["root"] / f"{first}_then_{then}"
    shutil.copytree(both["start"], d)
    crash = RefCrash if first == "ref" else InjectedCrash
    with pytest.raises(crash):
        both["run"](first, d, crash_at=8)
    assert CK.latest_step(str(d)) == RCK.latest_step(str(d)) == 8
    losses = both["run"](then, d)[2]["loss"]
    assert len(losses) == 4
    for who in ("ref", "port"):
        want = both["full"][who][8:]
        assert np.allclose(losses, want, rtol=CROSS_RTOL, atol=0), (
            who, losses, want)
    # the two packages' uninterrupted runs agree with each other too
    assert np.allclose(both["full"]["port"], both["full"]["ref"],
                       rtol=CROSS_RTOL, atol=0)


def test_training_checkpoint_loads_in_either_package(tmp_path):
    """``{"params", "opt": AdamWState}`` saved by each package and loaded
    by the other, every leaf bitwise, under the reference's names."""
    rc, pc = LT.configs("qwen2_5_3b", "float32")
    jp, tp = ref_weights(rc)
    ref_opt = ref_adamw_init(jp)
    ref_opt = ref_opt.__class__(step=jnp.int32(5), m=jax.tree_util.tree_map(
        lambda a: a + 1.5, ref_opt.m), v=jax.tree_util.tree_map(
        lambda a: a + 0.25, ref_opt.v))
    RCK.save_checkpoint(str(tmp_path / "ref"), 5, {"params": jp,
                                                   "opt": ref_opt})
    keys = set(np.load(tmp_path / "ref" / "step_00000005" / "arrays.npz")
               .files)
    assert {"opt/.step", "opt/.m/embed", "opt/.v/layers/ffn/w1"} <= keys
    proto = {"params": tp, "opt": adamw_init(tp)}
    got = CK.load_checkpoint(str(tmp_path / "ref"), 5, proto, device="cpu")
    assert isinstance(got["opt"], AdamWState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 5
    want = jax.tree_util.tree_map(np.asarray, {"params": jp, "m": ref_opt.m,
                                               "v": ref_opt.v})
    for name, tree in (("params", got["params"]), ("m", got["opt"].m),
                       ("v", got["opt"].v)):
        for path, leaf in tree_items(tree):
            w = want[name]
            for k in path:
                w = w[k]
            np.testing.assert_array_equal(leaf.numpy(), w)
    # and back: the port's save, the reference's load
    CK.save_checkpoint(str(tmp_path / "port"), 5, got)
    assert set(np.load(tmp_path / "port" / "step_00000005" / "arrays.npz")
               .files) == keys
    back = RCK.load_checkpoint(str(tmp_path / "port"), 5, jax.eval_shape(
        lambda: {"params": jp, "opt": ref_opt}))
    assert back["opt"].step.dtype == np.int32 and int(back["opt"].step) == 5
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves({"params": jp,
                                               "opt": ref_opt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the launcher and the example twin --------------------------------------

# the reference's last line (src/repro/launch/train.py)
FINAL = re.compile(r"^final loss: \d+\.\d{4}  stragglers: \d+$")


def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "6",
                   "--device", "cpu", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert FINAL.match(out[-1]), out[-1]
    assert CK.latest_step(str(tmp_path)) == 6


def test_launcher_refuses_a_mesh():
    for mesh in ("host", "pod", "multipod"):
        with pytest.raises(ValueError, match="19d"):
            launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--steps",
                           "1", "--device", "cpu", "--mesh", mesh])


def test_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = get_config("qwen2.5-3b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        TokenPipeline(cfg, 2, 32)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])


def test_example_twin_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_tiny_lm_torch.py"),
         "--steps", "3", "--dim", "64", "--device", "cpu", "--ckpt",
         str(tmp_path / "ck")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    import dataclasses
    from repro.configs import get_config as ref_config
    ref_cfg = dataclasses.replace(
        ref_config("qwen2.5-3b", smoke=True), vocab=32768, d_model=64,
        n_layers=8, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=256,
        max_seq=1024)
    assert lines[0] == f"model: {ref_cfg.param_count() / 1e6:.1f}M params"
    m = re.match(r"^loss: (\d+\.\d{3}) -> (\d+\.\d{3}) \(3 steps run this "
                 r"session\)$", lines[-1])
    assert m, lines[-1]
    assert CK.latest_step(str(tmp_path / "ck")) == 3
