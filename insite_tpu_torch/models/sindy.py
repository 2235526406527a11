"""The A-SINDy / INSITE estimator on the EQ_4 and the tumor families.

The discovered model is ``(coefs [A, F], PolynomialLibrary)``: one STLSQ
fit per treatment arm (2 on EQ_4, 4 on cancer_sim and EQ_5) over the
family's design matrix. A-SINDy predicts with
one rollout of that shared model (the rollout kernel with a coefficient
batch stride of 0). INSITE then fine-tunes the active coefficients per
patient: a damped Gauss-Newton (Levenberg-Marquardt) loop over the whole
cohort at once, whose residual Jacobian comes from the
rollout-with-sensitivities kernel, one launch per iteration, followed by
one launch of the rollout kernel for the predictions.

CPU tensors take each kernel's plain PyTorch version and CUDA tensors the
kernel; nothing falls back from one to the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from insite_tpu_torch.core.constants import STANDARD_DT
from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.discovery.differentiate import (
    finite_difference, savgol_smooth, smoothed_finite_difference)
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.discovery.stlsq import stlsq_hostsolve
from insite_tpu_torch.models.base import CausalEstimator
from insite_tpu_torch.ops.rollout import batched_rollout, rollout_with_sens
from insite_tpu_torch.sim.tumor import TUMOUR_DEATH_THRESHOLD


@dataclass
class SINDyConfig:
    """Hyperparameters; the fields and defaults of
    `insite_tpu.models.sindy.SINDyConfig`. Values of later slices
    (`wsindy`, `joint_model`, the degree-4 ablation, the BFGS solver) raise
    `NotImplementedError` in `SINDyRegressor`, as does a dataset that is
    none of EQ_4_*, CANCER_SIM and EQ_5_*."""

    dataset_name: str = 'EQ_4_A'
    sindy_threshold: float = 0.1
    sindy_alpha: float = 0.5
    lam: float = 10.0
    insite: bool = False
    wsindy: bool = False
    joint_model: bool = False
    smooth_input_data: bool = False
    use_smoothed_finite_difference: bool = False
    ablation_more_complex_basis_functions: bool = False
    sindy_quantize: bool = False
    sindy_quantize_global_model_round_to: int = 2
    wsindy_select: bool = True
    wsindy_threshold_grid: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    wsindy_alpha_grid: tuple = (0.5, 0.05, 0.005)
    wsindy_select_tol: float = 0.05
    wsindy_tumor_window_lens: tuple = (8, 5, 3)
    projection_horizon: int = 5
    treatment_mode: str = 'multiclass'
    max_stlsq_iter: int = 100
    bfgs_tol: float = 1e-12
    bfgs_maxiter: Optional[int] = None
    # 'gauss_newton': the Levenberg-Marquardt fine-tune (the only solver
    # ported); 'bfgs' is Slice 4
    insite_solver: str = 'gauss_newton'
    gn_iters: int = 12
    # the device of the tensors picks kernel or plain version; 'auto' is
    # the only value
    rollout_backend: str = 'auto'
    # rows per fine-tune call (None: the whole set in one call); the last
    # chunk is padded by repeating its final row
    finetune_chunk: Optional[int] = None
    # 'auto' (EQ_4: no clip; tumor family: [0, TUMOUR_DEATH_THRESHOLD]),
    # None, or an explicit (lo, hi)
    y_clip: object = 'auto'


def _is_eq4(name: str) -> bool:
    return 'EQ_4' in name


def _is_tumor(name: str) -> bool:
    return name.upper() == 'CANCER_SIM' or 'EQ_5' in name


def resolve_y_clip(y_clip, dataset_name: str):
    """'auto' -> the dataset's outcome range: None on EQ_4, whose decay
    ODE cannot diverge; [0, TUMOUR_DEATH_THRESHOLD] on the tumor family,
    the range its simulators clip the true volume to at every step."""
    if y_clip != 'auto':
        return y_clip
    if _is_eq4(dataset_name):
        return None
    return (0.0, float(TUMOUR_DEATH_THRESHOLD))


def _unserved(cfg: SINDyConfig) -> list:
    """The settings of later slices that ``cfg`` asks for."""
    out = []
    if not (_is_eq4(cfg.dataset_name) or _is_tumor(cfg.dataset_name)):
        out.append(f'dataset_name={cfg.dataset_name!r} (not a simulated '
                   'benchmark: real data is Slice 6)')
    for name in ('wsindy', 'joint_model',
                 'ablation_more_complex_basis_functions'):
        if getattr(cfg, name):
            out.append(f'{name}=True (Slice 4)')
    if cfg.insite_solver != 'gauss_newton':
        out.append(f'insite_solver={cfg.insite_solver!r} (Slice 4)')
    if cfg.rollout_backend != 'auto':
        out.append(f'rollout_backend={cfg.rollout_backend!r} (the tensors\' '
                   'device picks kernel or plain version)')
    return out


class SINDyRegressor(CausalEstimator):
    """A-SINDy (``cfg.insite`` False) or INSITE on ``device``, in ``dtype``
    (float32 unless given). Predictions come back as numpy, scaled like
    the dataset's outputs, ``[rows, T, 1]``."""

    def __init__(self, cfg: SINDyConfig, dataset_collection=None, *, device,
                 dtype=None):
        unserved = _unserved(cfg)
        if unserved:
            raise NotImplementedError(
                'not ported yet (ROADMAP.md): ' + ', '.join(unserved))
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = resolve_float(dtype)
        self.dt = STANDARD_DT
        self.global_equation_string = ''
        self.coefs = None          # [A, F] global coefficients, numpy
        self.library: Optional[PolynomialLibrary] = None
        self.insite = cfg.insite
        if dataset_collection is not None and \
                not dataset_collection.processed_data_multi:
            dataset_collection.process_data_multi(
                include_continuous_treatment='EQ_5' in cfg.dataset_name)

    @property
    def _n_arms(self) -> int:
        return 2 if _is_eq4(self.cfg.dataset_name) else 4

    # ------------------------------------------------------------------
    # helpers

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype or self.dtype,
                               device=self.device)

    def _unscaled_arrays(self, dataset):
        """(prev [N, T] observed y, statics [N, S], arms [N, T] int,
        lengths [N]) in the data's own units, numpy."""
        sp = dataset.scaling_params
        d = dataset.data
        dim_out = 1
        dim_static = d['static_features'].shape[-1]
        prev = np.squeeze(d['prev_outputs'], -1) * sp['output_stds'] \
            + sp['output_means']
        statics = d['static_features'] * \
            sp['inputs_stds'][dim_out:dim_out + dim_static] + \
            sp['input_means'][dim_out:dim_out + dim_static]
        treatments = d['current_treatments']
        if self.cfg.treatment_mode == 'multiclass':
            arms = np.argmax(treatments, axis=-1)
        else:
            arms = np.squeeze(treatments, -1).astype(np.int64) \
                if treatments.shape[-1] == 1 else treatments
        lengths = np.asarray(d['sequence_lengths']).astype(np.int64)
        return prev, statics, arms, lengths

    # ------------------------------------------------------------------
    # fitting

    def fit(self, train_f, val_f=None):
        cfg = self.cfg
        prev, statics, arms, lengths = self._unscaled_arrays(train_f)
        # the observed trajectory including its final observation
        unscaled_outputs = np.squeeze(train_f.data['unscaled_outputs'], -1)
        volumes = np.concatenate([prev[:, :1], unscaled_outputs], axis=1)
        self.library = PolynomialLibrary(n_inputs=1 + statics.shape[-1])
        fit = self._fit_eq4 if _is_eq4(cfg.dataset_name) else self._fit_tumor
        # the host STLSQ solves in float64; keep the compute dtype's values
        self.coefs = fit(volumes, statics, arms, lengths).astype(
            torch.empty((), dtype=self.dtype).numpy().dtype)
        round_to = (cfg.sindy_quantize_global_model_round_to
                    if cfg.sindy_quantize else None)
        if round_to is not None:
            # rollouts and the INSITE fine-tune (start and proximal anchor)
            # all use the quantized model
            self.coefs = np.round(self.coefs, round_to)

        names = self._input_names()
        eq_strs = [self.library.pretty_equation(
            self.coefs[a], names, quantize_round_to=round_to)
            for a in range(self.coefs.shape[0])]
        self.global_equation_string = ' | '.join(
            f'Treatment {a}: x_dot = {s}' for a, s in enumerate(eq_strs))
        return self

    def _input_names(self):
        n_controls = self.library.n_inputs - 1
        return ['x0'] + [f'u{i}' for i in range(n_controls)]

    def _fit_eq4(self, volumes, statics, arms, lengths):
        """EQ_4: each patient is one constant-arm trajectory of length
        seq_len - 1, differentiated by smoothed 4th-order finite
        differences; one STLSQ per arm."""
        eff_len = self._tensor(np.maximum(lengths - 1, 2), torch.int64)
        theta, xdot, ok, arm = _eq4_design(
            self._tensor(volumes), self._tensor(statics),
            self._tensor(arms, torch.int64), eff_len, self.dt,
            library=self.library, smooth=True, fd_order=4)
        return self._stlsq_per_arm(theta, xdot, ok, arm)

    def _fit_tumor(self, volumes, statics, arms, lengths):
        """cancer_sim / EQ_5: a sample at step j belongs to the system of
        arm[j] whenever j < seq_len; forward differences (order 1) pair
        (x_j, x_{j+1}) within the arm's segment. ``use_smoothed_finite_
        difference`` changes nothing here: the reference's smoother fits a
        line through 2 points, which reproduces them."""
        theta, xdot, ok, arm = _tumor_design(
            self._tensor(volumes), self._tensor(statics),
            self._tensor(arms, torch.int64),
            self._tensor(lengths, torch.int64), self.dt,
            library=self.library)
        return self._stlsq_per_arm(theta, xdot, ok, arm)

    def _stlsq_per_arm(self, theta, xdot, ok, arm):
        """One STLSQ per arm over the samples of that arm: [A, F]."""
        cfg = self.cfg
        return np.stack([stlsq_hostsolve(theta, xdot, cfg.sindy_threshold,
                                         cfg.sindy_alpha,
                                         sample_weight=ok & (arm == a),
                                         max_iter=cfg.max_stlsq_iter)[0]
                         for a in range(self._n_arms)])

    # ------------------------------------------------------------------
    # prediction

    def get_predictions(self, dataset) -> np.ndarray:
        if not self.insite:
            preds = self._global_rollout(dataset)
        else:
            preds = self._fine_tuned_rollout(dataset, projection_horizon=1)
        assert not np.any(np.isnan(preds)), 'Predictions contain NaN'
        return preds

    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        ph = self.cfg.projection_horizon
        if not self.insite:
            preds = self._global_rollout(dataset)
        else:
            preds = self._fine_tuned_rollout(dataset, projection_horizon=ph)
        lengths = np.asarray(dataset.data['sequence_lengths']).astype(int)
        lower = np.maximum(1, lengths - ph)
        win = lower[:, None] + np.arange(ph)[None, :]
        return preds[np.arange(preds.shape[0])[:, None], win]

    def _rollout_args(self, dataset):
        prev, statics, arms, lengths = self._unscaled_arrays(dataset)
        return (self._tensor(prev), self._tensor(statics),
                self._tensor(arms, torch.int32),
                self._tensor(lengths, torch.int64))

    def _y_clip(self):
        return resolve_y_clip(self.cfg.y_clip, self.cfg.dataset_name)

    def _scaled_numpy(self, preds, lengths, dataset) -> np.ndarray:
        """Zero the positions past each row's valid length (no metric reads
        them, and a diverging rollout may be inf there), scale like the
        outputs, and copy to the host once: [N, T, 1]."""
        valid = torch.arange(preds.shape[1], device=preds.device)[None, :] \
            < lengths[:, None]
        preds = torch.where(valid, preds, 0.0)
        sp = dataset.scaling_params
        preds = (preds - sp['output_means']) / sp['output_stds']
        return preds.cpu().numpy()[..., None]

    def _global_rollout(self, dataset) -> np.ndarray:
        prev, statics, arms, lengths = self._rollout_args(dataset)
        preds = batched_rollout(self.library, self._tensor(self.coefs)[None],
                                prev[:, 0], statics, arms, self.dt,
                                y_clip=self._y_clip())
        return self._scaled_numpy(preds, lengths, dataset)

    def _active_idx(self) -> tuple:
        """The flat (arm * F + feature) coordinates with |global coef| >
        1e-3: the coordinates the fine-tune moves."""
        return tuple(int(i) for i in
                     np.flatnonzero(np.abs(self.coefs).reshape(-1) > 1e-3))

    def _fine_tune(self, dataset, projection_horizon: int):
        """Run the per-patient fine-tune; returns (preds [N, T],
        per-patient coefs [N, A, F]) on the device.

        With ``cfg.finetune_chunk`` the rows go through in chunks of that
        size, the last one padded by repeating its final row."""
        cfg = self.cfg
        prev, statics, arms, lengths = self._rollout_args(dataset)
        if cfg.smooth_input_data:
            prev = savgol_smooth(prev, lengths)
        coefs = self._tensor(self.coefs)
        active_idx = self._active_idx()

        def solve(prev_c, statics_c, arms_c, lengths_c):
            if not active_idx:
                return _empty_support_predict(
                    self.library, coefs, prev_c, statics_c, arms_c,
                    lengths_c, self.dt, projection_horizon, self._y_clip())
            return insite_gn_finetune_predict(
                self.library, coefs, prev_c, statics_c, arms_c, lengths_c,
                self.dt, lam=cfg.lam, projection_horizon=projection_horizon,
                gn_iters=cfg.gn_iters, y_clip=self._y_clip(),
                active_idx=active_idx)

        chunk = cfg.finetune_chunk
        n = prev.shape[0]
        if not chunk or n <= chunk:
            return solve(prev, statics, arms, lengths)
        preds_l, coefs_l = [], []
        for i in range(0, n, chunk):
            take = min(chunk, n - i)

            def padded(x):
                xs = x[i:i + take]
                if take < chunk:
                    xs = torch.cat([xs, xs[-1:].expand(chunk - take,
                                                       *xs.shape[1:])])
                return xs

            p, c = solve(padded(prev), padded(statics), padded(arms),
                         padded(lengths))
            preds_l.append(p[:take])
            coefs_l.append(c[:take])
        return torch.cat(preds_l), torch.cat(coefs_l)

    def get_fine_tuned_coefficients(self, dataset,
                                    projection_horizon: int = 1):
        """Per-patient fine-tuned coefficients [N, A, F], numpy."""
        _, coefs = self._fine_tune(dataset, projection_horizon)
        return coefs.cpu().numpy()

    def _fine_tuned_rollout(self, dataset, projection_horizon: int):
        preds, _ = self._fine_tune(dataset, projection_horizon)
        lengths = self._tensor(
            np.asarray(dataset.data['sequence_lengths']).astype(np.int64),
            torch.int64)
        preds = self._scaled_numpy(preds, lengths, dataset)
        assert not np.any(np.isnan(preds) | np.isinf(preds))
        return preds


def _empty_support_predict(library, global_coefs, prev, statics, arms,
                           lengths, dt, projection_horizon: int,
                           y_clip=None):
    """The fine-tune when no global coefficient exceeds 1e-3: nothing can
    move, so rows longer than the horizon roll out the masked global model
    ``global * (|global| > 1e-3)`` and the others the full global model,
    in one rollout. Returns (preds [B, T], coefs [B, A, F])."""
    masked = global_coefs * (global_coefs.abs() > 1e-3)
    skip = (lengths <= projection_horizon)[:, None, None]
    coefs = torch.where(skip, global_coefs[None], masked[None])
    preds = batched_rollout(library, coefs, prev[:, 0], statics, arms, dt,
                            y_clip=y_clip)
    return preds, coefs


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


def _tumor_design(vol_j, statics, arms_idx, lengths, dt, library):
    """Tumor-family design build: forward differences of order 1, the
    features of each step's state and the sample masks, flattened over
    patients x steps.

    vol_j [B, T]; statics [B, S]; arms_idx [B, T-1] arm per step; lengths
    [B] valid transitions. Returns (theta [B*(T-1), F], xdot [B*(T-1)],
    sample_ok, arm)."""
    B, T = vol_j.shape
    xdot = (vol_j[:, 1:] - vol_j[:, :-1]) * (1.0 / dt)
    sample_ok = (torch.arange(T - 1, device=vol_j.device)[None, :]
                 < lengths[:, None])
    X = torch.cat([vol_j[:, :-1, None],
                   statics[:, None, :].expand(B, T - 1, statics.shape[-1])],
                  dim=-1)
    theta = library(X)
    F = theta.shape[-1]
    return (theta.reshape(-1, F), xdot.reshape(-1), sample_ok.reshape(-1),
            arms_idx.reshape(-1))


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
