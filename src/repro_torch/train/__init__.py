"""LM training on one device: the port of ``repro.train`` (AdamW, the
train step with microbatching and remat, the fault-tolerant loop;
``compress`` holds the error-feedback int8 gradient sync)."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, cosine_schedule, clip_by_global_norm,
)
from repro_torch.train.step import make_train_step  # noqa: F401
from repro_torch.train.loop import train_loop, TrainLoopConfig  # noqa: F401
