"""PyTorch + CUDA port of `insite_tpu` for one NVIDIA H100.

The layout mirrors the JAX package module by module. This package imports
torch, numpy and the standard library only; the JAX package is the
reference its tests hold it against.
"""
