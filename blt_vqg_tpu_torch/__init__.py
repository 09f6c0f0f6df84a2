"""PyTorch/CUDA port of blt_vqg_tpu: the serving decode path.

Mirrors the module paths of the JAX package (``ops/pallas/X.py`` becomes
``ops/kernels/X.py``, with the CUDA sources under ``csrc/``).  Imports torch
and numpy, never jax or the JAX package.
"""
