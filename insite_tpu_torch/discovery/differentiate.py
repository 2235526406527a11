"""Derivative estimation for discovery: Savitzky-Golay smoothing and
finite differences as one batched "clamped sliding window x coefficient
matrix" primitive.

For output position ``j`` in a trajectory of valid length ``L``, take the
window starting at ``s = clip(j - (w-1)//2, 0, L - w)`` and emit
``W[j - s] @ x[s:s+w]``. The polynomial-projection matrix gives savgol with
``mode='interp'`` edges; Fornberg derivative weights give centred finite
differences with one-sided boundary stencils. Ragged batches are handled by
the per-row clamp: one gather and one weighted sum for the whole cohort.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from insite_tpu_torch.utils.profiling import to_device


@lru_cache(maxsize=None)
def savgol_coeffs_matrix(window: int, polyorder: int) -> np.ndarray:
    """W[r, k]: value at in-window position r of the degree-``polyorder``
    least-squares fit through the ``window`` samples."""
    x = np.arange(window, dtype=np.float64)
    V = np.vander(x, polyorder + 1, increasing=True)      # [w, p+1]
    # projection onto the polynomial space: P = V (V^T V)^-1 V^T
    return V @ np.linalg.solve(V.T @ V, V.T)              # [w, w]


@lru_cache(maxsize=None)
def fornberg_matrix(window: int, deriv: int = 1) -> np.ndarray:
    """W[r, k]: weight of sample k for the ``deriv``-th derivative at
    in-window position r, on a unit-spaced window. Scale by 1/dt**deriv."""
    x = np.arange(window, dtype=np.float64)
    W = np.zeros((window, window))
    fact = float(math.factorial(deriv))
    for r in range(window):
        A = np.vander(x - x[r], window, increasing=True).T   # A[m,k]=(xk-xr)^m
        b = np.zeros(window)
        b[deriv] = fact
        W[r] = np.linalg.solve(A, b)
    return W


def windowed_filter(x: torch.Tensor, lengths: torch.Tensor,
                    W: np.ndarray) -> torch.Tensor:
    """Apply the clamped-window primitive along the last axis.

    x:       [..., T]  (padded)
    lengths: [...]     valid lengths per row (int); positions >= L produce
                        values the caller must mask.
    W:       [w, w]    coefficient matrix.
    """
    w = W.shape[0]
    T = x.shape[-1]
    half = (w - 1) // 2
    j = torch.arange(T, device=x.device)
    L = torch.clamp(lengths[..., None], min=w)             # guard short rows
    s = torch.minimum(torch.clamp(j - half, min=0), L - w)  # [..., T]
    # in-window position; past L it is clamped, as jax clamps the gather
    r = torch.clamp(j - s, max=w - 1)
    idx = s[..., None] + torch.arange(w, device=x.device)  # [..., T, w]
    windows = torch.gather(x, -1, idx.flatten(-2)).view(idx.shape)
    Wj = to_device(W, x.device, x.dtype)[r]
    # a fused multiply-add chain in window order: the rounding of the
    # JAX package's compiled reduction, so float64 results agree bit for bit
    out = windows[..., 0] * Wj[..., 0]
    for k in range(1, w):
        out = torch.addcmul(out, windows[..., k], Wj[..., k])
    return out


def savgol_smooth(x, lengths, window: int = 5, polyorder: int = 3):
    """Batched scipy-compatible ``savgol_filter(..., mode='interp')``."""
    return windowed_filter(x, lengths, savgol_coeffs_matrix(window,
                                                            polyorder))


def finite_difference(x, lengths, dt, order: int = 2, deriv: int = 1):
    """Batched pysindy-compatible ``FiniteDifference(order=order)``."""
    W = fornberg_matrix(order + 1, deriv)
    # times the reciprocal, as the JAX package's compiled division rounds
    return windowed_filter(x, lengths, W) * (1.0 / dt ** deriv)


def smoothed_finite_difference(x, lengths, dt, order: int = 4,
                               window: int = 5, polyorder: int = 3):
    """pysindy ``SmoothedFiniteDifference``: savgol smooth, then FD."""
    return finite_difference(savgol_smooth(x, lengths, window, polyorder),
                             lengths, dt, order=order)
