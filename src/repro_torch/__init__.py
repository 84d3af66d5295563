"""LiLIS learned spatial index on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` (which stays the reference): the
same modules and names, with the Pallas TPU kernels rewritten as
hand-written CUDA kernels (``repro_torch.kernels``), and the serving
path of the seed's LLM scaffold (``configs``, ``models``,
``data.tokens``, ``serve.api``; plain PyTorch). Entry points run
on the card unless the caller passes ``device="cpu"``; with no card,
the default raises.

This package imports torch and numpy only — never jax, never repro.
"""
