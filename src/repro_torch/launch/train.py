"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--smoke]``.

The port of ``repro.launch.train``: runs the fault-tolerant loop
(auto-resume, async checkpoints, straggler watchdog) on one device, the
card unless given ``--device cpu``. Smoke configs train a ~100k-param
model; a full config at its published width needs the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --steps 6 --device cpu

``--mesh`` takes only ``none``: the meshed step (``host``, ``pod``,
``multipod``) is ROADMAP item 19d.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import build_model
from repro_torch.train import TrainLoopConfig, make_train_step, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "host", "pod", "multipod"],
                    default="none")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="fault injection (testing)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise ValueError(f"--mesh {args.mesh}: meshed training is not "
                         "ported yet (ROADMAP item 19d); use --mesh none")

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    step = make_train_step(model, n_micro=args.micro, peak_lr=args.lr,
                           total_steps=args.steps)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=0,
                         device=args.device)
    loop_cfg = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every,
                               crash_at_step=args.crash_at)
    params, opt, hist = train_loop(model, step, pipe, loop_cfg, seed=0)
    print(f"final loss: {hist['loss'][-1]:.4f}  "
          f"stragglers: {hist['stragglers']}")


if __name__ == "__main__":
    main()
