"""Train a ~100M-param qwen2.5-family model for a few hundred steps on
one device, with checkpoint/auto-resume: the end-to-end training driver
at example scale, on the PyTorch port.

The twin of ``examples/train_tiny_lm.py`` (the JAX package's): the same
config (qwen2.5-3b's smoke config widened to ``--dim``, 8 layers, vocab
32768), batch 8 x 256 tokens from seed 0, peak rate 3e-4 after 20 warmup
steps, a checkpoint every 100 steps. Its checkpoints go to their own
directory (``repro_torch_tiny_lm`` in the temporary directory, or
``--ckpt``). Runs on the card unless given ``--device cpu``.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_tiny_lm_torch.py --steps 3 \\
        --dim 64 --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import build_model
from repro_torch.train import TrainLoopConfig, make_train_step, train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_tiny_lm"))
    ap.add_argument("--dim", type=int, default=512,
                    help="512 -> ~100M params with the qwen vocab")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = dataclasses.replace(
        get_config("qwen2.5-3b", smoke=True),
        vocab=32768, d_model=args.dim, n_layers=8,
        n_heads=8, n_kv_heads=2, head_dim=args.dim // 8,
        d_ff=args.dim * 4, max_seq=1024)
    model = build_model(cfg)
    n = cfg.param_count()
    print(f"model: {n/1e6:.1f}M params")

    step = make_train_step(model, peak_lr=3e-4, warmup=20,
                           total_steps=args.steps, n_micro=1)
    pipe = TokenPipeline(cfg, batch=8, seq=256, seed=0, device=args.device)
    loop = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt,
                           ckpt_every=100, log_every=20)
    params, opt, hist = train_loop(model, step, pipe, loop, seed=0)
    print(f"loss: {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
          f"({len(hist['loss'])} steps run this session)")


if __name__ == "__main__":
    main()
