"""Rollout kernels (CUDA) with their plain PyTorch versions."""
