"""Carry the system's state from numpy into the port's tensors.

The "weights" of this system are the simulator's parameter dict, the
discovered global coefficients ``[A, F]`` and the per-patient coefficients
``[B, A, F]``. These helpers take numpy arrays (for example pulled from the
JAX package with ``np.asarray``) so that both packages compute from the
same state.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(d: dict, device, dtype) -> dict:
    """Simulator parameters: every array becomes a tensor of ``dtype`` on
    ``device``; scalars (noise level, sigmoid constants, window) stay
    Python numbers."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        out[k] = (torch.as_tensor(a, dtype=dtype, device=device)
                  if a.ndim > 0 else a.item())
    return out


def coefs_from_numpy(c, device, dtype) -> torch.Tensor:
    """Global ``[A, F]`` or per-patient ``[B, A, F]`` coefficients."""
    return torch.as_tensor(np.asarray(c), dtype=dtype, device=device)
