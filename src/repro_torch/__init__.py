"""PyTorch/CUDA port of the serving data plane, beside the JAX package.

Imports ``torch`` and numpy only, never ``jax`` or the JAX package. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
