"""PyTorch/CUDA port of GeoDiffuser-TPU for NVIDIA Hopper.

The JAX package `geodiffuser_tpu` is the reference; every module here has one
counterpart there, and the Pallas kernels are hand-written CUDA kernels under
`csrc/`.  This package imports torch, never jax.
"""
