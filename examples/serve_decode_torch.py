"""Batched serving example on the PyTorch port: prefill + greedy decode
with KV caches, across three cache disciplines (GQA / MLA-compressed /
RWKV state) and hymba's window cache + SSM state.

The twin of ``examples/serve_decode.py`` (the JAX package's): the same
four archs at their smoke size, random weights from seed 0, a batch of
4 prompts of 32 tokens from ``make_batch(seed=1)``, 24 greedy tokens,
one line per arch with the tokens per second and the first row's first
tokens. ``--compute-dtype`` overrides the archs' compute dtype (e.g.
float32); ``--params DIR`` serves the weights of the checkpoint in
``DIR/<arch>`` (its newest step, as either package's
``save_checkpoint`` writes them) in place of the random ones.

    PYTHONPATH=src python examples/serve_decode_torch.py                # card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""
import argparse
import dataclasses
import os
import time

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.tokens import make_batch
from repro_torch.models import build_model
from repro_torch.models.common import init_shapes, tree_map
from repro_torch.serve import generate

ARCHS = ["qwen2.5-3b", "deepseek-v2-lite-16b", "rwkv6-3b", "hymba-1.5b"]


def load_params(cfg, path: str, device):
    """The newest checkpoint under ``path``, shaped as ``cfg``'s tree."""
    proto = tree_map(lambda s: torch.empty(s, device="meta"),
                     init_shapes(cfg))
    return load_checkpoint(path, latest_step(path), proto, device=device)


def run(arch: str, device, steps: int = 24, compute_dtype=None,
        params_dir=None):
    cfg = get_config(arch, smoke=True)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = build_model(cfg)
    if params_dir is None:
        params = model.init(0, device=device)
    else:
        params = load_params(cfg, os.path.join(params_dir, arch), device)
    batch = make_batch(cfg, 4, 32, seed=1, device=device)
    b = {"tokens": batch["tokens"]}
    if "patches" in batch:
        b["patches"] = batch["patches"]
    t0 = time.perf_counter()
    out = generate(model, params, b, steps=steps, device=device)
    first = out[0, :6].tolist()         # waits for the device
    dt = time.perf_counter() - t0
    kind = {"transformer": "GQA/MLA cache", "rwkv6": "O(1) state",
            "hymba": "window cache + SSM state"}.get(cfg.family,
                                                     cfg.family)
    print(f"{arch:24s} [{kind:22s}] {out.shape[0] * out.shape[1] / dt:7.1f}"
          f" tok/s  first tokens: {first}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--compute-dtype", default=None,
                    help="override every arch's compute dtype")
    ap.add_argument("--params", default=None, metavar="DIR",
                    help="serve the checkpoint DIR/<arch> of each arch")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for arch in ARCHS:
        run(arch, dev, compute_dtype=args.compute_dtype,
            params_dir=args.params)


if __name__ == "__main__":
    main()
