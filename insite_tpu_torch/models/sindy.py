"""EQ_4 design matrix and the INSITE Levenberg-Marquardt fine-tune.

The discovered model is ``(coefs [A, F], PolynomialLibrary)``. INSITE then
fine-tunes the active coefficients per patient: a damped Gauss-Newton
(Levenberg-Marquardt) loop over the whole cohort at once, whose residual
Jacobian comes from the rollout-with-sensitivities kernel, one launch per
iteration, followed by one launch of the plain rollout kernel for the
predictions.
"""

from __future__ import annotations

import torch

from insite_tpu_torch.discovery.differentiate import (
    finite_difference, smoothed_finite_difference)
from insite_tpu_torch.ops.rollout import batched_rollout, rollout_with_sens


def _eq4_design(vol_j, statics, arms01, eff_len, dt, library,
                smooth=True, fd_order=4):
    """EQ_4 design-matrix build (one ODE per arm): derivative estimate,
    feature matrix and sample masks, flattened over patients x time.

    vol_j [B, T]; statics [B, S]; arms01 [B, T] (arm per patient in column
    0); eff_len [B] valid lengths. Returns (theta [B*T, F], xdot [B*T],
    sample_ok [B*T], arm [B*T])."""
    if smooth:
        xdot = smoothed_finite_difference(vol_j, eff_len, dt, order=fd_order)
    else:
        xdot = finite_difference(vol_j, eff_len, dt, order=fd_order)
    B, T = vol_j.shape
    sample_ok = (torch.arange(T, device=vol_j.device)[None, :]
                 < eff_len[:, None])
    X = torch.cat([vol_j[..., None],
                   statics[:, None, :].expand(B, T, statics.shape[-1])],
                  dim=-1)
    theta = library(X)
    F = theta.shape[-1]
    return (theta.reshape(-1, F), xdot.reshape(-1), sample_ok.reshape(-1),
            arms01[:, :1].expand(B, T).reshape(-1))


def insite_gn_finetune_predict(library, global_coefs, prev, statics, arms,
                               lengths, dt, lam, projection_horizon: int,
                               gn_iters: int = 12, y_clip=None,
                               active_idx=()):
    """INSITE fine-tune: per-patient Levenberg-Marquardt over the active
    coefficients, then the rollout of each patient's model.

    Objective (the reference's f_to_min_func):
        prefix_mse(c) / (2.5 * prefix_mse(c_global)) + lam * mean((c - g)^2)
    over the first ``lengths - projection_horizon`` one-step errors. Each
    iteration evaluates the pending candidate with one
    rollout-with-sensitivities call, keeps it only if it lowers the
    objective (deferred acceptance), and proposes the next step from a
    batched [B, Kr, Kr] solve. Rows with ``lengths <= projection_horizon``
    keep, and roll out, the full unmasked global coefficients.

    global_coefs [A, F]; prev [B, T] observed y[0..T-1]; statics [B, S];
    arms [B, T]; lengths [B]; active_idx: the flat (arm * F + feature)
    coordinates with |global coef| > 1e-3. Returns (preds [B, T],
    coefs [B, A, F]).

    The float32 contractions below go through cuBLAS in full float32:
    PyTorch leaves TF32 off for matmuls (torch.backends.cuda.matmul.
    allow_tf32 is False) unless a caller turns it on, and callers of this
    function must not.
    """
    if len(active_idx) == 0:
        raise ValueError('the fine-tune needs at least one active '
                         'coefficient')
    dev, dtype = prev.device, prev.dtype
    global_coefs = global_coefs.to(dtype)
    A, F = global_coefs.shape
    K = A * F
    act = torch.tensor(active_idx, device=dev)
    Kr = len(active_idx)
    B, T = prev.shape
    sparse_flat = (global_coefs.abs() > 1e-3).to(dtype).reshape(-1)
    g_red = global_coefs.reshape(-1)[act]

    ph = projection_horizon
    prefix = (torch.arange(T - 1, device=dev)[None, :]
              < (lengths - ph)[:, None])                        # [B, T-1]
    n_mask = torch.clamp(prefix.to(dtype).sum(1), min=1.0)      # [B]
    skip = lengths <= ph                                        # [B]
    eye = torch.eye(Kr, dtype=dtype, device=dev)
    reg2 = lam / K                                              # reg_scale^2

    def to_full(c_red):                                         # [B, Kr]
        c = torch.zeros((B, K), dtype=dtype, device=dev)
        c[:, act] = c_red
        return (c * sparse_flat[None, :]).reshape(B, A, F)

    def resid_jac(c_red):
        y, s = rollout_with_sens(library, to_full(c_red), prev[:, 0],
                                 statics, arms, dt, active_idx, y_clip=y_clip)
        r = torch.where(prefix, prev[:, 1:] - y[:, :-1], 0.0)
        J = torch.where(prefix[..., None], -s[:, :-1, :], 0.0)
        return r, J

    r0, J0 = resid_jac(g_red.expand(B, Kr))
    mse0 = (r0 ** 2).sum(1) / n_mask
    ds = 1.0 / torch.sqrt(2.5 * torch.clamp(mse0, min=1e-30) * n_mask)

    def full_obj(r, c):
        return ((r * ds[:, None]) ** 2).sum(1) + \
            reg2 * ((c - g_red[None, :]) ** 2).sum(1)

    def solve_step(r, J, c, mu):
        Js = J * ds[:, None, None]
        JtJ = torch.einsum('btj,btk->bjk', Js, Js) + reg2 * eye[None]
        rhs = -torch.einsum('btj,bt->bj', Js, r * ds[:, None]) \
            - reg2 * (c - g_red[None, :])
        # solve_ex: no host sync for the error check; a non-finite row
        # yields a non-finite candidate, which the acceptance test rejects
        delta = torch.linalg.solve_ex(JtJ + mu[:, None, None] * eye[None],
                                      rhs[..., None])[0][..., 0]
        return c + delta

    c_best = g_red.expand(B, Kr)
    r_best, J_best = r0, J0
    obj_best = full_obj(r0, c_best)
    mu = torch.full((B,), 1e-3, dtype=dtype, device=dev)
    cand = solve_step(r_best, J_best, c_best, mu)
    for _ in range(gn_iters):
        r_c, J_c = resid_jac(cand)
        obj_c = full_obj(r_c, cand)
        better = torch.isfinite(obj_c) & (obj_c < obj_best)
        c_best = torch.where(better[:, None], cand, c_best)
        obj_best = torch.where(better, obj_c, obj_best)
        r_best = torch.where(better[:, None], r_c, r_best)
        J_best = torch.where(better[:, None, None], J_c, J_best)
        mu = torch.clamp(torch.where(better, mu * 0.3, mu * 10.0), 1e-8, 1e8)
        cand = solve_step(r_best, J_best, c_best, mu)

    coefs = torch.where(skip[:, None], g_red[None, :], c_best)
    # skip rows roll out the FULL unmasked global model: to_full drops
    # retained sub-threshold (|coef| <= 1e-3) entries
    coefs_full = torch.where(skip[:, None, None], global_coefs[None],
                             to_full(coefs))
    preds = batched_rollout(library, coefs_full, prev[:, 0], statics, arms,
                            dt, y_clip=y_clip)
    return preds, coefs_full
