"""PyTorch + CUDA port of the Guided FP-growth / Minority-Report system.

Mirrors the JAX package ``repro`` module for module.  Imports ``torch`` and
never ``jax``; every count goes through the hand-written Hopper kernel in
``kernels/itemset_count/csrc`` on a CUDA tensor, or through its plain
PyTorch version on a CPU tensor.
"""
