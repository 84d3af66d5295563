"""Model zoo of the LM scaffold, the port of ``repro.models``.

Families: transformer (GQA / MLA / MoE / sliding-window / enc-dec / VLM
stub), rwkv6 (attention-free), hymba (parallel attention + SSM heads).
All models expose the same functional API via ``registry.build_model``:

  init(seed, device=) -> params (nested dict of float32 tensors)
  train_loss(params, batch) -> scalar loss (each layer of the stack
      checkpointed: ``transformer.set_remat_policy``; autograd gives
      the gradients, ``repro_torch.train`` the step)
  prefill(params, batch, max_len=None) -> (logits, cache)
  decode_step(params, cache, tokens, pos) -> (logits, cache)

Plain PyTorch: the reference reaches no Pallas kernel on this path.
"""
from repro_torch.models.registry import build_model  # noqa: F401
