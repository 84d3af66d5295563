"""The port's LM serving against the JAX package, on the CPU.

``ServeSession`` steps the same tokens as the reference's session, for
qwen2.5 (a GQA cache) and rwkv6 (an O(1) state) at smoke size and on
the same weights, past ``max_len`` too (both write the last slot there),
and gives the same logits at every step. The launcher's LM mode runs on
the CPU when asked; without ``device=`` every LM entry point asks for
the card, and raises here where there is none. ``mesh=`` and ``rules=``
are not ported (ROADMAP item 19d) and raise.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.serve import ServeSession as RefSession
from repro_torch.configs import get_config
from repro_torch.data.tokens import make_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import ServeSession, generate, make_decode, \
    make_prefill
from test_torch_lm_models import BF16_ATOL, close_f32, ref_weights, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b"])
def test_serve_session_matches_reference(arch, dtype):
    rc = dataclasses.replace(ref_config(arch, smoke=True),
                             compute_dtype=dtype)
    pc = dataclasses.replace(get_config(arch, smoke=True),
                             compute_dtype=dtype)
    rp, pp = ref_weights(rc, seed=4)
    batch, max_len, steps = 3, 8, 11
    want = RefSession(ref_build(rc), rp, batch_size=batch, max_len=max_len)
    got = ServeSession(build_model(pc), pp, batch_size=batch,
                       max_len=max_len, device=CPU)
    toks = np.random.default_rng(2).integers(0, rc.vocab, (steps, batch, 1),
                                             dtype=np.int32)
    for i in range(steps):
        wl = want.step(jnp.asarray(toks[i]))
        gl = got.step(torch.from_numpy(toks[i]))
        assert gl.shape == (batch, 1, rc.vocab) and gl.dtype == pc.cdtype
        if dtype == "float32":
            close_f32(gl, wl, f"step {i}")
        else:
            assert np.abs(to_np(gl) - to_np(wl)).max() < BF16_ATOL, i
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    if dtype == "float32":
        close_f32(got.cache, want.cache, "cache")


def test_launcher_serves_an_lm_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2.5-3b", "--smoke", "--tokens", "8", "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "generated (4, 8) tokens" in out.stdout, out.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


def test_lm_entry_points_default_to_the_card(no_card):
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    batch = {"tokens": make_batch(cfg, 2, 8, device=CPU)["tokens"]}
    for call in (lambda: model.init(0),
                 lambda: make_batch(cfg, 2, 8),
                 lambda: generate(model, params, batch, steps=2),
                 lambda: ServeSession(model, params, 2, 16),
                 lambda: launch_serve.main(["--arch", "qwen2.5-3b",
                                            "--smoke", "--tokens", "2"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_meshed_serving_is_refused():
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    batch = {"tokens": make_batch(cfg, 2, 8, device=CPU)["tokens"]}
    for call in (lambda: make_prefill(model, mesh=object()),
                 lambda: make_decode(model, rules=object()),
                 lambda: generate(model, params, batch, steps=2,
                                  mesh=object(), device=CPU),
                 lambda: ServeSession(model, params, 2, 16, mesh=object(),
                                      device=CPU)):
        with pytest.raises(ValueError, match="19d"):
            call()
