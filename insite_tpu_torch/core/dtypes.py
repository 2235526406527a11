"""Dtype policy: float32 unless the caller names another type.

The CUDA kernels' main path is float32. There is no global 64-bit switch:
reference-parity tests on the CPU pass ``torch.float64`` explicitly.
"""

import torch


def resolve_float(dtype=None) -> torch.dtype:
    return torch.float32 if dtype is None else dtype
