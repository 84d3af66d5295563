"""Step-atomic checkpoints of trees of tensors (``checkpoint/store.py``),
on the reference's on-disk layout."""
from repro_torch.checkpoint.store import (  # noqa: F401
    latest_step, load_checkpoint, read_meta, restore_or_init, rows_of,
    save_checkpoint,
)
