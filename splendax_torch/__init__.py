"""PyTorch/CUDA port of splendax for one NVIDIA H100.

Imports torch and numpy only; the JAX package `splendax` is the reference
it is tested against.  See README.md, "PyTorch/CUDA port".
"""
