"""Fault-tolerant training loop.

The port of ``repro.train.loop``:
  * auto-resume: restores params/opt/data-cursor from the newest valid
    checkpoint (a killed job restarts bit-exact);
  * step-atomic async checkpointing every ``ckpt_every`` steps (each
    save joins the previous one first, and the loop joins the last);
  * straggler watchdog: EMA of step wall-time; steps slower than
    ``straggler_factor`` x EMA are logged and counted;
  * crash injection (``crash_at_step``) for restart tests.

The loop reads one value per step back to the host, the loss (the
reference's ``float(metrics["loss"])``); the step itself makes no host
sync. It runs where the pipeline's batches are (``pipeline.device``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import restore_or_init, save_checkpoint
from repro_torch.data.tokens import TokenPipeline
from repro_torch.train.optimizer import adamw_init


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    crash_at_step: Optional[int] = None   # fault injection (tests)
    async_ckpt: bool = True


class InjectedCrash(RuntimeError):
    pass


def train_loop(model, step, pipeline: TokenPipeline,
               loop_cfg: TrainLoopConfig, seed: int = 0,
               log_fn: Callable[[str], None] = print):
    """Returns (params, opt_state, history dict) with ``history``'s
    "loss" (floats, the steps run here), "stragglers" and "step_times"
    (seconds). A fresh start draws the parameters from ``seed``
    (``model.init``)."""
    dev = pipeline.device

    def fresh():
        # restore_or_init builds its prototype with this under
        # torch.device("meta"): there it must allocate nothing, so it
        # takes that device; a fresh start takes the pipeline's
        here = torch.get_default_device()
        params = model.init(seed, device=here if here.type == "meta"
                            else dev)
        return {"params": params, "opt": adamw_init(params)}

    start_step = 0
    if loop_cfg.ckpt_dir:
        state, start_step = restore_or_init(loop_cfg.ckpt_dir, fresh,
                                            device=dev)
        if start_step:
            log_fn(f"[resume] restored step {start_step} from "
                   f"{loop_cfg.ckpt_dir}")
    else:
        state = fresh()
    params, opt = state["params"], state["opt"]
    if step.shard_in is not None:
        params, opt, _ = step.shard_in(params, opt, next(TokenPipeline(
            pipeline.cfg, pipeline.batch, pipeline.seq, device=dev)))
    pipeline.skip_to(start_step)

    history = {"loss": [], "stragglers": 0, "step_times": []}
    ema = None
    pending = None
    for i in range(start_step, loop_cfg.steps):
        batch = next(pipeline)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        history["loss"].append(loss)
        history["step_times"].append(dt)
        if ema is not None and dt > loop_cfg.straggler_factor * ema:
            history["stragglers"] += 1
            log_fn(f"[watchdog] straggler step {i}: {dt*1e3:.1f}ms "
                   f"(ema {ema*1e3:.1f}ms)")
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt

        if loop_cfg.log_every and i % loop_cfg.log_every == 0:
            log_fn(f"step {i:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")

        done = i + 1
        if loop_cfg.ckpt_dir and (done % loop_cfg.ckpt_every == 0 or
                                  done == loop_cfg.steps):
            if pending is not None:
                pending.join()
            # an async save copies every leaf to the host before it
            # returns, so the next step may update them in place
            pending = save_checkpoint(
                loop_cfg.ckpt_dir, done, {"params": params, "opt": opt},
                meta={"arch": pipeline.cfg.name},
                async_write=loop_cfg.async_ckpt)

        if loop_cfg.crash_at_step is not None and \
                done == loop_cfg.crash_at_step:
            if pending is not None:
                pending.join()
            raise InjectedCrash(f"injected crash after step {done}")

    if pending is not None:
        pending.join()
    return params, opt, history
