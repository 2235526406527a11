"""Sequentially-thresholded least squares on a QR-reduced problem.

The N-row reduction runs on the device (`_qr_reduce`, a QR of the weighted
feature matrix); only the F x (F+1) triangle goes to the host, where the
tiny STLSQ thresholding iteration runs in float64 numpy
(`stlsq_from_qr`), with the semantics of pysindy's STLSQ plus the unbias
refit.

One deliberate difference from `insite_tpu.discovery.stlsq`: where the
support's columns are linearly dependent (the EQ_5 A/B design, whose
single patient type makes the 'u0' column a copy of '1' and 'x0 u0' one of
'x0'), the unbias refit takes the minimum-norm least-squares solution, as
the reference's unbias (a scikit-learn LinearRegression) does; the JAX
package raises `LinAlgError` there. Elsewhere both solve the same normal
equations, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _qr_reduce(theta: torch.Tensor, y: torch.Tensor, sample_weight=None):
    """QR of the weighted feature matrix: returns (R [F, F], Q^T y [F]).

    Forming Theta^T Theta directly in float32 destroys the near-collinear
    directions of the polynomial library (the EQ_4 statics are 0.5 +- 0.05,
    so the '1'/'u0'/'u1'/'u0 u1' block is nearly rank one); QR keeps the
    error at eps * cond(Theta). R is unique up to the sign of each row.

    On the card the QR is cuSOLVER's; on the host it is numpy's LAPACK,
    whose factorization is the JAX package's host QR bit for bit (torch's
    CPU build links another LAPACK), so the discovered coefficients and
    their printed equation match the reference's exactly in float64.
    """
    if sample_weight is not None:
        w = torch.sqrt(sample_weight.to(theta.dtype))
        theta = theta * w[:, None]
        y = y * w
    A = torch.cat([theta, y[:, None]], dim=1)
    if A.device.type == 'cpu':
        R = torch.from_numpy(np.linalg.qr(A.numpy(), mode='r'))
    else:
        R = torch.linalg.qr(A, mode='r').R
    F = theta.shape[-1]
    return R[:F, :F], R[:F, F]


def stlsq_from_qr(R, qty, threshold, alpha, max_iter: int = 100,
                  initial_mask=None, unbias: bool = True):
    """The F x F STLSQ thresholding iteration on a QR-reduced problem, in
    float64 on the host. Takes numpy (R, Q^T y); returns numpy
    (coefs [F], mask [F]). The unbias refit treats the support as rank
    deficient when the smallest singular value of its columns of R is at
    most F times the epsilon of R's own type (the precision of the QR)
    times the largest."""
    R = np.asarray(R)
    F = R.shape[0]
    rcond = F * np.finfo(R.dtype).eps
    R = R.astype(np.float64)
    qty = np.asarray(qty, np.float64)
    gram = R.T @ R
    rhs = R.T @ qty

    def solve(mask, a):
        m = mask.astype(np.float64)
        A = gram * np.outer(m, m) + np.diag(a * m + (1.0 - m))
        return np.linalg.solve(A, rhs * m)

    mask = (np.ones(F, bool) if initial_mask is None
            else np.asarray(initial_mask, bool))
    coefs = np.zeros(F)
    for _ in range(max_iter):
        if not mask.any():
            break
        c = solve(mask, alpha)
        new_mask = (np.abs(c) >= threshold) & mask
        coefs = np.where(new_mask, c, 0.0)
        if (new_mask == mask).all():
            mask = new_mask
            break
        mask = new_mask
    if unbias and mask.any():
        sv = np.linalg.svd(R[:, mask], compute_uv=False)
        if sv[-1] > rcond * sv[0]:
            coefs = np.where(mask, solve(mask, 0.0), 0.0)
        else:
            coefs = np.zeros(F)
            coefs[mask] = np.linalg.lstsq(R[:, mask], qty, rcond=rcond)[0]
    return coefs, mask


def stlsq_hostsolve(theta, y, threshold, alpha, sample_weight=None,
                    max_iter: int = 100, initial_mask=None,
                    unbias: bool = True):
    """Global-discovery STLSQ: the N-row QR reduction on the tensors'
    device, the F x F thresholding iteration on the host. Returns numpy
    (coefs [F], mask [F])."""
    R, qty = _qr_reduce(theta, y, sample_weight)
    return stlsq_from_qr(R.cpu().numpy(), qty.cpu().numpy(), threshold,
                         alpha, max_iter=max_iter, initial_mask=initial_mask,
                         unbias=unbias)
