"""Sequentially-thresholded least squares on a QR-reduced problem.

The N-row reduction runs on the device (`_qr_reduce`, a QR of the weighted
feature matrix; `_qr_reduce_arms`, every arm's from one pass over the
design); only the F x (F+1) triangles go to the host, where the tiny STLSQ
thresholding iteration runs in float64 numpy (`stlsq_from_qr`), with the
semantics of pysindy's STLSQ plus the unbias refit.

The vectorized seed columns take `stlsq`, the JAX package's masked-ridge
form (a relative ridge floor, 20 fixed iterations), batched over seeds:
the [S, F, F] normal equations are formed in float64 on the device and
solved in float64 on the host whatever the compute dtype (F <= 7, S <= 10).
`masked_ridge` is one such solve, as the JAX package exports it.

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

from insite_tpu_torch.ops.qr_reduce import qr_reduce
from insite_tpu_torch.utils.profiling import span, to_device, to_host


def _host_triangle(theta, y, sample_weight=None):
    """numpy's LAPACK QR of the weighted ``[theta | y]`` on the host, in
    theta's dtype: R [F + 1, F + 1] (zero rows below N)."""
    if sample_weight is not None:
        w = torch.sqrt(sample_weight.to(theta.dtype))
        theta = theta * w[:, None]
        y = y * w
    A = torch.cat([theta, y[:, None]], dim=1).numpy()
    R = np.linalg.qr(A, mode='r')
    if len(R) < A.shape[1]:
        R = np.concatenate([R, np.zeros((A.shape[1] - len(R), A.shape[1]),
                                        R.dtype)])
    return torch.from_numpy(R)


def _qr_reduce(theta: torch.Tensor, y: torch.Tensor, sample_weight=None):
    """QR of the weighted feature matrix: returns (R [F, F], Q^T y [F]).

    Forming Theta^T Theta directly in float32 destroys the near-collinear
    directions of the polynomial library (the EQ_4 statics are 0.5 +- 0.05,
    so the '1'/'u0'/'u1'/'u0 u1' block is nearly rank one); QR keeps the
    error at eps * cond(Theta). R is unique up to the sign of each row.

    On the card the QR is the TSQR kernel's (`ops.qr_reduce`, one arm,
    float64 arithmetic); on the host it is numpy's LAPACK, whose
    factorization is the JAX package's host QR bit for bit (torch's CPU
    build links another LAPACK), so the discovered coefficients and their
    printed equation match the reference's exactly in float64.
    The reduction is the span 'fit.qr', timed on the device too.
    """
    with span('fit.qr', theta.device):
        if theta.device.type == 'cpu':
            R = _host_triangle(theta, y, sample_weight)
        else:
            w = (None if sample_weight is None else
                 sample_weight.to(theta.dtype).contiguous())
            R = qr_reduce(theta.contiguous(), y.contiguous(), weight=w)[0]
        F = theta.shape[-1]
        return R[:F, :F], R[:F, F]


def _qr_reduce_arms(theta, y, ok, arm, n_arms: int):
    """Each arm's `_qr_reduce` from one reduction: the triangles
    ``[R_k | Q_k^T y_k]`` [n_arms, F + 1, F + 1] (R_k = [k, :F, :F],
    Q_k^T y_k = [k, :F, F]) of the rows with ``ok`` and ``arm == k``
    (``arm`` None: every ok row, one arm). On the card one call of the
    TSQR kernels reads the design once for every arm; on the host each
    arm is `_qr_reduce`'s LAPACK QR with the arm's 0/1 weight, bit for bit.
    The span 'fit.qr'."""
    with span('fit.qr', theta.device):
        if theta.device.type == 'cpu':
            return torch.stack([_host_triangle(
                theta, y, ok if arm is None else ok & (arm == a))
                for a in range(n_arms)])
        return qr_reduce(theta.contiguous(), y.contiguous(), n_arms,
                         ok=ok.contiguous(),
                         arm=None if arm is None else arm.contiguous())


def _qr_reduce_sharded(thetas, ys, sample_weights=None):
    """`_qr_reduce` of rows split into shards (TSQR): each shard's
    ``[R_i | Q_i^T y_i]`` on its own device, then those F-row blocks
    stacked on the first shard's device and reduced once more. The result
    is that of the unsharded rows up to the sign of each row of R: the
    stacked blocks have the Gram matrix and right-hand side of the whole
    problem. A shard with fewer rows than F + 1 is padded with zero rows,
    which change neither."""
    F = thetas[0].shape[-1]
    blocks = []
    for i, (theta, y) in enumerate(zip(thetas, ys)):
        w = None if sample_weights is None else sample_weights[i]
        short = F + 1 - theta.shape[0]
        if short > 0:
            theta = torch.cat([theta, theta.new_zeros(short, F)])
            y = torch.cat([y, y.new_zeros(short)])
            w = None if w is None else torch.cat([w, w.new_zeros(short)])
        R, qty = _qr_reduce(theta, y, w)
        blocks.append(torch.cat([R, qty[:, None]], dim=1))
    lead = blocks[0].device
    stacked = torch.cat([b.to(lead) for b in blocks])       # [n F, F + 1]
    return _qr_reduce(stacked[:, :F], stacked[:, F])


@span('fit')
@span('fit.stlsq')
def stlsq_from_qr(R, qty, threshold, alpha, max_iter: int = 100,
                  initial_mask=None, unbias: bool = True):
    """The F x F STLSQ thresholding iteration on a QR-reduced problem, in
    float64 on the host (the span 'fit.stlsq'). Takes numpy (R, Q^T y);
    returns numpy (coefs [F], mask [F]). The unbias refit treats the
    support as rank deficient when the smallest singular value of its
    columns of R is at most F times the epsilon of R's own type (the
    precision of the QR) times the largest."""
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
    (coefs [F], mask [F]).

    ``theta``, ``y`` and ``sample_weight`` may also be lists of row shards
    (`parallel.shard_rows`, each on its device, with the shards'
    `parallel.row_mask` in the weight, so that the padding weighs 0): the
    reduction is then `_qr_reduce_sharded`'s, and the coefficients do not
    depend on the number of shards."""
    if isinstance(theta, (list, tuple)):
        R, qty = _qr_reduce_sharded(theta, y, sample_weight)
    else:
        R, qty = _qr_reduce(theta, y, sample_weight)
    return stlsq_from_qr(to_host(R).numpy(), to_host(qty).numpy(),
                         threshold, alpha, max_iter=max_iter,
                         initial_mask=initial_mask, unbias=unbias)


def _normal_equations(theta, y, sample_weight=None):
    """The weighted normal equations of a seed-stacked problem, in float64
    on the host: theta [S, N, F], y and sample_weight [S, N] (no weight:
    every row weighs 1). Each seed's gram [F, F] and right-hand side [F]
    are accumulated in float64 on the tensors' device, one seed at a time:
    the same 2-D products whatever the number of seeds, so a block of a
    column's seeds (a sharded column) gets the whole column's bits. Returns
    numpy (gram [S, F, F], rhs [S, F])."""
    th = theta.double()
    w = (torch.ones_like(th[..., 0]) if sample_weight is None
         else sample_weight.double())
    yw = y.double() * w
    gram = torch.stack([(t * ws[:, None]).T @ t for t, ws in zip(th, w)])
    rhs = torch.stack([t.T @ v for t, v in zip(th, yw)])
    return to_host(gram).numpy(), to_host(rhs).numpy()


def _masked_solve(gram, rhs, mask, alpha):
    """Solve (gram + alpha I) c = rhs restricted to the ``mask`` columns,
    batched over seeds, in float64 numpy: gram [S, F, F], rhs and mask
    [S, F], alpha [S]. Masked columns get a unit diagonal and a zero
    right-hand side, so their coefficients are exactly 0."""
    m = mask.astype(np.float64)
    eye = np.eye(gram.shape[-1])
    A = gram * m[:, :, None] * m[:, None, :] + \
        eye * (alpha[:, None, None] * m[:, None, :] + (1.0 - m)[:, None, :])
    return np.linalg.solve(A, (rhs * m)[..., None])[..., 0]


def masked_ridge(theta, y, alpha, mask=None, sample_weight=None):
    """One masked ridge solve, `insite_tpu.discovery.stlsq.masked_ridge`:
    the coefficients [F] that minimise ``|W^(1/2) (theta c - y)|^2 +
    alpha |c|^2`` over the ``mask`` columns (all of them without one),
    0 elsewhere. theta [N, F], y and sample_weight [N]. ``alpha`` is used
    as given: the relative floor is `stlsq`'s alone. The normal equations
    are formed and solved in float64 (`_normal_equations`); the result is
    a tensor of theta's dtype on theta's device."""
    gram, rhs = _normal_equations(
        theta[None], y[None],
        None if sample_weight is None else sample_weight[None])
    F = rhs.shape[-1]
    mask = (np.ones(F, bool) if mask is None
            else to_host(torch.as_tensor(mask)).numpy().astype(bool))
    c = _masked_solve(gram, rhs, mask[None], np.full(1, float(alpha)))[0]
    return to_device(c, theta.device, theta.dtype)


def stlsq(theta, y, threshold, alpha, sample_weight=None,
          max_iter: int = 20, unbias: bool = True):
    """The masked-ridge STLSQ of `insite_tpu.discovery.stlsq.stlsq`,
    batched over a leading seed axis: theta [S, N, F] (or [N, F]), y and
    sample_weight [S, N] (or [N]). Returns numpy (coefs [S, F], support
    [S, F]), without the seed axis if the input had none.

    Each iteration solves the ridge normal equations restricted to the
    support (`_masked_solve`) and thresholds; ``max_iter`` fixed
    iterations reach the fixed point of the reference's converge-or-break
    loop. The ridge is ``max(alpha, floor)`` with the JAX package's
    relative floor ``rel * trace(gram) / F`` (rel 1e-6 for float32
    inputs, 1e-12 otherwise), which keeps an exactly duplicated column
    pair (EQ_5_A's constant static) solvable; the unbias refit takes the
    floor alone.

    The JAX package forms and solves these equations in the compute dtype;
    here they are formed in float64 on the tensors' device, seed by seed
    (`_normal_equations`), and the F x F solves run in float64 on the
    host."""
    batched = theta.ndim == 3
    if not batched:
        theta, y = theta[None], y[None]
        sample_weight = None if sample_weight is None else sample_weight[None]
    rel = 1e-6 if theta.dtype == torch.float32 else 1e-12
    gram, rhs = _normal_equations(theta, y, sample_weight)
    S, F = rhs.shape
    floor = rel * np.trace(gram, axis1=1, axis2=2) / F          # [S]
    alpha_eff = np.maximum(alpha, floor)

    mask = np.ones((S, F), bool)
    coefs = np.zeros((S, F))
    for _ in range(max_iter):
        c = _masked_solve(gram, rhs, mask, alpha_eff)
        mask = (np.abs(c) >= threshold) & mask
        coefs = np.where(mask, c, 0.0)
    if unbias:
        coefs = np.where(mask, _masked_solve(gram, rhs, mask, floor), 0.0)
    if not batched:
        return coefs[0], mask[0]
    return coefs, mask
