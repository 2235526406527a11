"""The A-SINDy / A-WSINDy / INSITE estimator on the EQ_4 and the tumor
families.

The discovered model is ``(coefs [A, F], PolynomialLibrary)``: one sparse
fit per treatment arm (2 on EQ_4, 4 on cancer_sim and EQ_5) over the
family's design matrix: STLSQ on the strong form (A-SINDy), or, with
``cfg.wsindy``, the weak form of `discovery/wsindy.py` with its candidate
grid scored on the strong-form design. A-SINDy and A-WSINDy predict with
one rollout of that shared model (the rollout kernel with a coefficient
batch stride of 0). INSITE then fine-tunes the active coefficients per
patient: a damped Gauss-Newton (Levenberg-Marquardt) loop over the whole
cohort at once, whose residual Jacobian comes from the
rollout-with-sensitivities kernel, one launch per iteration, followed by
one launch of the rollout kernel for the predictions.

Two ablations: ``cfg.ablation_more_complex_basis_functions`` takes the
full degree-4 library (its fine-tune goes through in chunks of 2048 rows),
and ``cfg.joint_model`` fits one ODE whose library also reads the binary
treatment inputs; its rollouts and sensitivities run on the same kernels,
folded onto a per-arm model by `ops/joint_fold.py`.

CPU tensors take each kernel's plain PyTorch version and CUDA tensors the
kernel; nothing falls back from one to the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from insite_tpu_torch.core.constants import STANDARD_DT
from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.discovery.differentiate import (
    finite_difference, savgol_smooth, smoothed_finite_difference)
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.discovery.stlsq import stlsq_hostsolve
from insite_tpu_torch.discovery.wsindy import (weak_candidates_host,
                                               weak_select_host, weak_system,
                                               weak_system_segments)
from insite_tpu_torch.models.base import CausalEstimator
from insite_tpu_torch.ops.joint_fold import JointFold, combination_index
from insite_tpu_torch.ops.rollout import batched_rollout, rollout_with_sens
from insite_tpu_torch.sim.tumor import TUMOUR_DEATH_THRESHOLD


@dataclass
class SINDyConfig:
    """Hyperparameters; the fields and defaults of
    `insite_tpu.models.sindy.SINDyConfig`. The BFGS solver raises
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
    # the weak fit's candidate grid: sindy_threshold times each multiplier,
    # paired with each ridge alpha (correlation units); the sparsest
    # candidate whose strong-form training residual is within
    # wsindy_select_tol of the best is kept. Off: one candidate at
    # (sindy_threshold, alpha 0.5)
    wsindy_select: bool = True
    wsindy_threshold_grid: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    wsindy_alpha_grid: tuple = (0.5, 0.05, 0.005)
    wsindy_select_tol: float = 0.05
    # tumor-family weak windows, each kept only inside one arm's segment
    wsindy_tumor_window_lens: tuple = (8, 5, 3)
    projection_horizon: int = 5
    treatment_mode: str = 'multiclass'
    max_stlsq_iter: int = 100
    bfgs_tol: float = 1e-12
    bfgs_maxiter: Optional[int] = None
    # 'gauss_newton': the Levenberg-Marquardt fine-tune (the only solver
    # ported; 'bfgs' raises)
    insite_solver: str = 'gauss_newton'
    gn_iters: int = 12
    # the device of the tensors picks kernel or plain version; 'auto' is
    # the only value
    rollout_backend: str = 'auto'
    # rows per fine-tune call (None: the whole set in one call, or 2048
    # with the degree-4 library); the last chunk is padded by repeating its
    # final row
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
                   'benchmark: the JAX package serves no SINDy fit on real '
                   'data)')
    if cfg.insite_solver != 'gauss_newton':
        out.append(f'insite_solver={cfg.insite_solver!r} (the BFGS '
                   'fine-tune is ported only when a caller needs it)')
    if cfg.rollout_backend != 'auto':
        out.append(f'rollout_backend={cfg.rollout_backend!r} (the tensors\' '
                   'device picks kernel or plain version)')
    return out


class SINDyRegressor(CausalEstimator):
    """A-SINDy, A-WSINDy (``cfg.wsindy``) or INSITE (``cfg.insite``) on
    ``device``, in ``dtype`` (float32 unless given). Predictions come back
    as numpy, scaled like the dataset's outputs, ``[rows, T, 1]``."""

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
        self._fold: Optional[JointFold] = None     # set by a joint fit
        self.insite = cfg.insite
        if dataset_collection is not None and \
                not dataset_collection.processed_data_multi:
            dataset_collection.process_data_multi(
                include_continuous_treatment='EQ_5' in cfg.dataset_name)

    @property
    def _n_arms(self) -> int:
        if self.cfg.joint_model:
            return 1
        return 2 if _is_eq4(self.cfg.dataset_name) else 4

    # ------------------------------------------------------------------
    # helpers

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype or self.dtype,
                               device=self.device)

    def _unscaled_arrays(self, dataset):
        """(prev [N, T] observed y, statics [N, S], arms, lengths [N]) in
        the data's own units, numpy. arms: [N, T] int (the arm, or
        multilabel EQ_4's one binary column) or, multilabel on the tumor
        family, the [N, T, 2] (chemo, radio) labels."""
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
        if cfg.joint_model and not _is_eq4(cfg.dataset_name) and \
                cfg.treatment_mode != 'multilabel':
            # a 4-valued arm index is not the two binary inputs of the
            # joint tumor library
            raise ValueError('joint_model on the tumor family needs '
                             "treatment_mode='multilabel'")
        prev, statics, arms, lengths = self._unscaled_arrays(train_f)
        # the observed trajectory including its final observation
        unscaled_outputs = np.squeeze(train_f.data['unscaled_outputs'], -1)
        volumes = np.concatenate([prev[:, :1], unscaled_outputs], axis=1)
        n_treatments = 0
        if cfg.joint_model:
            n_treatments = arms.shape[-1] if arms.ndim == 3 else 1
        degree_kw = (dict(degree=4, interaction_only=False)
                     if cfg.ablation_more_complex_basis_functions
                     else dict(degree=2, interaction_only=True))
        self.library = PolynomialLibrary(
            n_inputs=1 + n_treatments + statics.shape[-1], **degree_kw)
        self._fold = (JointFold(self.library, n_treatments)
                      if cfg.joint_model else None)
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
        if cfg.joint_model:
            self.global_equation_string = f'Joint Model: x_dot = {eq_strs[0]}'
        else:
            self.global_equation_string = ' | '.join(
                f'Treatment {a}: x_dot = {s}' for a, s in enumerate(eq_strs))
        return self

    def _input_names(self):
        n_controls = self.library.n_inputs - 1
        return ['x0'] + [f'u{i}' for i in range(n_controls)]

    def _fit_eq4(self, volumes, statics, arms, lengths):
        """EQ_4: each patient is one constant-arm trajectory of length
        seq_len - 1, differentiated by smoothed 4th-order finite
        differences; one STLSQ per arm, or the weak fit."""
        cfg = self.cfg
        eff_len = self._tensor(np.maximum(lengths - 1, 2), torch.int64)
        volumes, statics = self._tensor(volumes), self._tensor(statics)
        arms = self._tensor(arms, torch.int64)
        design = _eq4_design(volumes, statics, arms, eff_len, self.dt,
                             library=self.library, smooth=True, fd_order=4,
                             joint=cfg.joint_model)
        if not cfg.wsindy:
            return self._stlsq_per_arm(*design)
        volumes, statics = _weak_precision(volumes, statics)
        arm0 = arms[:, 0]
        if cfg.joint_model:
            # As the JAX package computes this cell: it hands the weak
            # system the statics alone, one input short of the joint
            # library's [y, arm, statics], and its library reads the
            # missing last input as the one before it (an out-of-range
            # index clamps there). So the weak integrand sees
            # [y, c0, c1, c1] and the arm never enters: a defect of the
            # reference, mirrored so that the table's cell is the same
            # number in both packages.
            inputs = torch.cat([statics, statics[:, -1:]], 1)
            systems = [weak_system(volumes, inputs, eff_len, self.library,
                                   self.dt)]
        else:
            systems = [weak_system(volumes, statics, eff_len, self.library,
                                   self.dt, trajectory_mask=(arm0 == a))
                       for a in range(self._n_arms)]
        return self._weak_solve_arms(systems, design)

    def _fit_tumor(self, volumes, statics, arms, lengths):
        """cancer_sim / EQ_5: a sample at step j belongs to the system of
        arm[j] whenever j < seq_len; forward differences (order 1) pair
        (x_j, x_{j+1}) within the arm's segment. ``use_smoothed_finite_
        difference`` changes nothing here: the reference's smoother fits a
        line through 2 points, which reproduces them. The weak fit takes
        multi-scale all-starts windows, each inside one arm's segment."""
        cfg = self.cfg
        if cfg.wsindy and cfg.joint_model:
            raise ValueError(
                'wsindy with joint_model is served on EQ_4 only: the joint '
                'tumor library takes treatment inputs that vary along a '
                'trajectory, which the weak integrand does not thread')
        volumes, statics = self._tensor(volumes), self._tensor(statics)
        lengths = self._tensor(lengths, torch.int64)
        arms = self._tensor(arms, None if cfg.joint_model else torch.int64)
        design = _tumor_design(volumes, statics, arms, lengths, self.dt,
                               library=self.library, joint=cfg.joint_model)
        if not cfg.wsindy:
            return self._stlsq_per_arm(*design)
        volumes, statics = _weak_precision(volumes, statics)
        # `lengths` transitions pair lengths + 1 valid volume points
        systems = [weak_system_segments(
            volumes, statics, lengths + 1, self.library, self.dt, arms, a,
            window_lens=cfg.wsindy_tumor_window_lens)
            for a in range(self._n_arms)]
        return self._weak_solve_arms(systems, design)

    def _arm_weight(self, ok, arm, a):
        """The samples of arm ``a`` (the joint model: every valid one)."""
        return ok if self.cfg.joint_model else ok & (arm == a)

    def _stlsq_per_arm(self, theta, xdot, ok, arm):
        """One STLSQ per arm over the samples of that arm: [A, F]."""
        cfg = self.cfg
        return np.stack([stlsq_hostsolve(theta, xdot, cfg.sindy_threshold,
                                         cfg.sindy_alpha,
                                         sample_weight=self._arm_weight(
                                             ok, arm, a),
                                         max_iter=cfg.max_stlsq_iter)[0]
                         for a in range(self._n_arms)])

    def _weak_solve_arms(self, systems, design):
        """Per arm, the candidate weak solves and the strong-form
        selection, in float64 on the host: [A, F]. Every arm's weak system
        and the strong-form design come over from the device first."""
        systems = [tuple(x.cpu().numpy() for x in sys_a)
                   for sys_a in systems]
        theta, xdot, ok, arm = (x.cpu().numpy() for x in design)
        grid, alphas = wsindy_grid(self.cfg)
        coefs = []
        for a, (A, b, w) in enumerate(systems):
            cands = weak_candidates_host(A, b, w, grid, alphas)
            if len(grid) == 1:
                coefs.append(cands[0])
                continue
            coefs.append(weak_select_host(
                cands, theta, xdot, self._arm_weight(ok, arm, a),
                select_tol=self.cfg.wsindy_select_tol)[0])
        return np.stack(coefs)

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
        """(prev, statics, arms [N, T] int32, lengths) on the device; the
        joint model's arm is the combination index of the step's binary
        treatment inputs."""
        prev, statics, arms, lengths = self._unscaled_arrays(dataset)
        if self.cfg.joint_model:
            arms = combination_index(arms)
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
        roll, _ = _rollouts(self.library, self._fold)
        preds = roll(self._tensor(self.coefs)[None], prev[:, 0], statics,
                     arms, self.dt, y_clip=self._y_clip())
        return self._scaled_numpy(preds, lengths, dataset)

    def _active_idx(self) -> tuple:
        """The flat (arm * F + feature) coordinates with |global coef| >
        1e-3: the coordinates the fine-tune moves."""
        return tuple(int(i) for i in
                     np.flatnonzero(np.abs(self.coefs).reshape(-1) > 1e-3))

    def _fine_tune(self, dataset, projection_horizon: int, lam_grid=None):
        """Run the per-patient fine-tune; returns (preds [N, T],
        per-patient coefs [N, A, F]) on the device.

        With ``lam_grid`` (G values of the proximal penalty) the rows are
        stacked G times on the batch axis, copy g fine-tuned with
        ``lam_grid[g]``, all in one fine-tune: preds [G * N, T]. Otherwise
        every row takes ``cfg.lam``.

        With ``cfg.finetune_chunk`` (2048 by default with the degree-4
        library, whose Jacobian is [rows, T, up to A * 35]) the rows go
        through in chunks of that size, the last one padded by repeating
        its final row."""
        cfg = self.cfg
        prev, statics, arms, lengths = self._rollout_args(dataset)
        if cfg.smooth_input_data:
            prev = savgol_smooth(prev, lengths)
        lam = cfg.lam
        if lam_grid is not None:
            n_rows = prev.shape[0]
            prev, statics, arms, lengths = (
                x.repeat(len(lam_grid), *[1] * (x.ndim - 1))
                for x in (prev, statics, arms, lengths))
            lam = torch.tensor(lam_grid, dtype=torch.float64,
                               device=prev.device).repeat_interleave(n_rows)
        coefs = self._tensor(self.coefs)
        active_idx = self._active_idx()

        def solve(prev_c, statics_c, arms_c, lengths_c, lam_c):
            if not active_idx:
                return _empty_support_predict(
                    self.library, coefs, prev_c, statics_c, arms_c,
                    lengths_c, self.dt, projection_horizon, self._y_clip(),
                    fold=self._fold)
            return insite_gn_finetune_predict(
                self.library, coefs, prev_c, statics_c, arms_c, lengths_c,
                self.dt, lam=lam_c, projection_horizon=projection_horizon,
                gn_iters=cfg.gn_iters, y_clip=self._y_clip(),
                active_idx=active_idx, fold=self._fold)

        chunk = cfg.finetune_chunk
        if chunk is None and cfg.ablation_more_complex_basis_functions:
            chunk = 2048
        n = prev.shape[0]
        if not chunk or n <= chunk:
            return solve(prev, statics, arms, lengths, lam)
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
                         padded(lengths),
                         padded(lam) if torch.is_tensor(lam) else lam)
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


def wsindy_grid(cfg: SINDyConfig):
    """(thresholds [G], paired alphas [G]) of the weak fit's candidate
    grid: ``cfg.sindy_threshold`` times each multiplier, each paired with
    every ridge alpha; one candidate without ``cfg.wsindy_select``."""
    if cfg.wsindy_select:
        ths = np.asarray(cfg.wsindy_threshold_grid, float) * \
            cfg.sindy_threshold
        als = np.asarray(cfg.wsindy_alpha_grid, float)
        return np.repeat(ths, len(als)), np.tile(als, len(ths))
    return np.asarray([cfg.sindy_threshold]), np.asarray([0.5])


def _weak_precision(volumes, statics):
    """The weak systems are integrated in float64 on the device whatever
    the compute dtype: -<phi', x> is a signed sum that cancels, the host
    solves it in float64 anyway, and 15 thresholded candidates an arm turn
    float32 rounding into flipped supports (EQ_5_A, seed 0: a 0.7 % RMSE
    gap to the float64 fit against 0.01 % this way)."""
    return volumes.double(), statics.double()


def _rollouts(library, fold: Optional[JointFold] = None):
    """(rollout, rollout with sensitivities) of a per-arm model over
    ``library`` or, given ``fold``, of the joint model it folds: both take
    (coefs, y0, statics, arms, dt, ...) as `ops/rollout.py`'s do after the
    library."""
    if fold is not None:
        return fold.rollout, fold.rollout_with_sens
    return partial(batched_rollout, library), \
        partial(rollout_with_sens, library)


def _empty_support_predict(library, global_coefs, prev, statics, arms,
                           lengths, dt, projection_horizon: int,
                           y_clip=None, fold=None):
    """The fine-tune when no global coefficient exceeds 1e-3: nothing can
    move, so rows longer than the horizon roll out the masked global model
    ``global * (|global| > 1e-3)`` and the others the full global model,
    in one rollout. global_coefs [A, F], or [B, A, F] per row. Returns
    (preds [B, T], coefs [B, A, F])."""
    g = global_coefs if global_coefs.ndim == 3 else global_coefs[None]
    masked = g * (g.abs() > 1e-3)
    skip = (lengths <= projection_horizon)[:, None, None]
    coefs = torch.where(skip, g, masked)
    roll, _ = _rollouts(library, fold)
    preds = roll(coefs, prev[:, 0], statics, arms, dt, y_clip=y_clip)
    return preds, coefs


def _eq4_design(vol_j, statics, arms01, eff_len, dt, library,
                smooth=True, fd_order=4, joint=False):
    """EQ_4 design-matrix build: derivative estimate, feature matrix and
    sample masks, flattened over patients x time. The library reads
    [y, statics] (one ODE per arm) or, with ``joint``, [y, arm, statics].

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
    parts = [vol_j[..., None],
             statics[:, None, :].expand(B, T, statics.shape[-1])]
    if joint:
        parts.insert(1, arms01[:, :1, None].to(vol_j.dtype).expand(B, T, 1))
    theta = library(torch.cat(parts, dim=-1))
    F = theta.shape[-1]
    return (theta.reshape(-1, F), xdot.reshape(-1), sample_ok.reshape(-1),
            arms01[:, :1].expand(B, T).reshape(-1))


def _tumor_design(vol_j, statics, arms_idx, lengths, dt, library,
                  joint=False):
    """Tumor-family design build: forward differences of order 1, the
    features of each step's state and the sample masks, flattened over
    patients x steps.

    vol_j [B, T]; statics [B, S]; arms_idx [B, T-1] arm per step, or with
    ``joint`` the [B, T-1, 2] (chemo, radio) labels, which the library then
    reads between y and the statics; lengths [B] valid transitions. Returns
    (theta [B*(T-1), F], xdot [B*(T-1)], sample_ok, arm: all zeros with
    ``joint``)."""
    B, T = vol_j.shape
    xdot = (vol_j[:, 1:] - vol_j[:, :-1]) * (1.0 / dt)
    sample_ok = (torch.arange(T - 1, device=vol_j.device)[None, :]
                 < lengths[:, None])
    parts = [vol_j[:, :-1, None],
             statics[:, None, :].expand(B, T - 1, statics.shape[-1])]
    if joint:
        parts.insert(1, arms_idx.to(vol_j.dtype))
        arm = torch.zeros(B * (T - 1), dtype=torch.int64, device=vol_j.device)
    else:
        arm = arms_idx.reshape(-1)
    theta = library(torch.cat(parts, dim=-1))
    F = theta.shape[-1]
    return (theta.reshape(-1, F), xdot.reshape(-1), sample_ok.reshape(-1),
            arm)


def insite_gn_finetune_predict(library, global_coefs, prev, statics, arms,
                               lengths, dt, lam, projection_horizon: int,
                               gn_iters: int = 12, y_clip=None,
                               active_idx=(), fold=None):
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
    arms [B, T]; lengths [B]; lam a float, or a [B] tensor, a penalty per
    row (the lam grid's rows stacked); active_idx: the flat
    (arm * F + feature) coordinates with |global coef| > 1e-3. Returns
    (preds [B, T], coefs [B, A, F]).

    global_coefs may also be [B, A, F], a global model per row (the
    vectorized seed columns: each row its own seed's), with active_idx the
    union of the rows' supports. Each row then moves only its own
    support: the kernel's sensitivities of the union coordinates outside
    it are zeroed, so those stay at the row's global value and are masked
    out of its model, as in the JAX package's full-K problem, where they
    have a zero Jacobian. A row whose support is empty rolls out its
    masked global model, as `_empty_support_predict` gives.

    With ``fold`` (a `JointFold` of ``library``) the
    model is the joint one: global_coefs [1, F_joint], arms the combination
    index per step, and the loop works on the joint coordinates while the
    kernels run the folded per-arm model.

    The float32 contractions below go through cuBLAS in full float32:
    PyTorch leaves TF32 off for matmuls (torch.backends.cuda.matmul.
    allow_tf32 is False) unless a caller turns it on, and callers of this
    function must not.
    """
    if len(active_idx) == 0:
        raise ValueError('the fine-tune needs at least one active '
                         'coefficient')
    dev, dtype = prev.device, prev.dtype
    roll, roll_sens = _rollouts(library, fold)
    per_row = global_coefs.ndim == 3
    g_rows = global_coefs.to(dtype)
    if not per_row:
        g_rows = g_rows[None]                                   # [1|B, A, F]
    A, F = g_rows.shape[1:]
    K = A * F
    act = torch.tensor(active_idx, device=dev)
    Kr = len(active_idx)
    B, T = prev.shape
    sparse_flat = (g_rows.abs() > 1e-3).to(dtype).reshape(-1, K)
    g_red = g_rows.reshape(-1, K)[:, act]                       # [1|B, Kr]
    # each row's own support among the union's coordinates
    own = sparse_flat[:, act] > 0 if per_row else None          # [B, Kr]

    ph = projection_horizon
    prefix = (torch.arange(T - 1, device=dev)[None, :]
              < (lengths - ph)[:, None])                        # [B, T-1]
    n_mask = torch.clamp(prefix.to(dtype).sum(1), min=1.0)      # [B]
    skip = lengths <= ph                                        # [B]
    eye = torch.eye(Kr, dtype=dtype, device=dev)
    if torch.is_tensor(lam):
        # per row; lam / K in float64, then rounded once, as for a float
        reg2 = (lam.to(torch.float64) / K).to(dtype)            # [B]
        reg2_vec, reg2_mat = reg2[:, None], reg2[:, None, None]
    else:
        reg2 = reg2_vec = reg2_mat = lam / K                    # reg_scale^2

    def to_full(c_red):                                         # [B, Kr]
        c = torch.zeros((B, K), dtype=dtype, device=dev)
        c[:, act] = c_red
        return (c * sparse_flat).reshape(B, A, F)

    def resid_jac(c_red):
        y, s = roll_sens(to_full(c_red), prev[:, 0], statics, arms, dt,
                         active_idx, y_clip=y_clip)
        r = torch.where(prefix, prev[:, 1:] - y[:, :-1], 0.0)
        J = torch.where(prefix[..., None], -s[:, :-1, :], 0.0)
        if per_row:
            J = torch.where(own[:, None, :], J, 0.0)
        return r, J

    r0, J0 = resid_jac(g_red.expand(B, Kr))
    mse0 = (r0 ** 2).sum(1) / n_mask
    ds = 1.0 / torch.sqrt(2.5 * torch.clamp(mse0, min=1e-30) * n_mask)

    def full_obj(r, c):
        return ((r * ds[:, None]) ** 2).sum(1) + \
            reg2 * ((c - g_red) ** 2).sum(1)

    def solve_step(r, J, c, mu):
        Js = J * ds[:, None, None]
        JtJ = torch.einsum('btj,btk->bjk', Js, Js) + reg2_mat * eye[None]
        rhs = -torch.einsum('btj,bt->bj', Js, r * ds[:, None]) \
            - reg2_vec * (c - g_red)
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

    coefs = torch.where(skip[:, None], g_red, c_best)
    # skip rows roll out the FULL unmasked global model: to_full drops
    # retained sub-threshold (|coef| <= 1e-3) entries
    coefs_full = torch.where(skip[:, None, None], g_rows, to_full(coefs))
    preds = roll(coefs_full, prev[:, 0], statics, arms, dt, y_clip=y_clip)
    return preds, coefs_full
