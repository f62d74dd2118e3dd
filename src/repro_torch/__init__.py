"""PyTorch/CUDA port of the hybrid systolic reproduction.

The JAX package ``repro`` is the reference; this package computes the same
functions with plain PyTorch around hand-written Hopper kernels
(``repro_torch/csrc``), emulating the systolic PE ring on one card.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
