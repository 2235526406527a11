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
one launch of the rollout kernel for the predictions; or, with
``insite_solver='bfgs'``, a lock-step batched BFGS whose every objective
and gradient evaluation is one launch of the same sensitivity kernel.
``rollout_backend='xla'`` runs no kernel: the Levenberg-Marquardt Jacobian
then comes from forward-mode autodiff through the plain rollout, and every
rollout is the plain version.

The fine-tunes move the coordinates `support` gives of the host global
model, and an empty support is one rollout. One loop, `_lm_loop`, runs
the Levenberg-Marquardt chain on every path; on the card, where issuing a
link's small operations takes longer than running them, the links between
two launches replay from CUDA graphs.

Two ablations: ``cfg.ablation_more_complex_basis_functions`` takes the
full degree-4 library (its fine-tune goes through in chunks of 2048 rows),
and ``cfg.joint_model`` fits one ODE whose library also reads the binary
treatment inputs; its rollouts and sensitivities run on the same kernels,
folded onto a per-arm model by `ops/joint_fold.py`.

Otherwise CPU tensors take each kernel's plain PyTorch version and CUDA
tensors the kernel; nothing falls back from one to the other.

With a ``mesh`` (`parallel.batch_mesh`), the rows a model predicts are
sharded over its devices: each shard's rollouts and fine-tune run on its
own device, through the kernels on every CUDA shard, and the predictions
are gathered on ``device``. The fit is not sharded, as in the JAX package.
Where the JAX package takes XLA under a mesh (GSPMD cannot partition a
Pallas call), ``'auto'`` here launches the kernels on every shard.

`SINDyRegressor.fit` is the tracer's span 'fit' (`utils/profiling.py`),
its two prediction calls and the fine-tunes the span 'predict'.
"""

from __future__ import annotations

import copy
from collections import OrderedDict, namedtuple
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
from insite_tpu_torch.discovery.stlsq import (_qr_reduce_arms,
                                              stlsq_from_qr)
from insite_tpu_torch.discovery.wsindy import (weak_candidates_host,
                                               weak_select_host, weak_system,
                                               weak_system_segments)
from insite_tpu_torch.models.base import CausalEstimator
from insite_tpu_torch.ops.bfgs import minimize_bfgs
from insite_tpu_torch.ops.joint_fold import JointFold, combination_index
from insite_tpu_torch.ops.rollout import (batched_rollout,
                                          batched_rollout_plain,
                                          kernel_bounds, rollout_with_sens,
                                          rollout_with_sens_plain)
from insite_tpu_torch.parallel import gather_rows, shard_rows
from insite_tpu_torch.sim.tumor import TUMOUR_DEATH_THRESHOLD
from insite_tpu_torch.utils.profiling import (count, span, to_device,
                                              to_host)


@dataclass
class SINDyConfig:
    """Hyperparameters; the fields and defaults of
    `insite_tpu.models.sindy.SINDyConfig`. A dataset that is none of
    EQ_4_*, CANCER_SIM and EQ_5_* raises `NotImplementedError` in
    `SINDyRegressor`."""

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
    # changes nothing: the JAX package hands it to `minimize` as ``tol``,
    # which its BFGS ignores (gtol stays 1e-5)
    bfgs_tol: float = 1e-12
    # BFGS iterations a row (None: 200 * A * F)
    bfgs_maxiter: Optional[int] = None
    # 'gauss_newton' (Levenberg-Marquardt) or 'bfgs'
    insite_solver: str = 'gauss_newton'
    gn_iters: int = 12
    # 'auto': the device of the tensors picks kernel or plain version;
    # 'pallas': the kernels, and CUDA tensors are required; 'xla': the
    # plain versions on any device, the Levenberg-Marquardt Jacobian from
    # jvp through the plain rollout
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


INSITE_SOLVERS = ('gauss_newton', 'bfgs')
ROLLOUT_BACKENDS = ('auto', 'pallas', 'xla')


def _unserved(cfg: SINDyConfig) -> list:
    """The settings ``cfg`` asks for that no package serves."""
    out = []
    if not (_is_eq4(cfg.dataset_name) or _is_tumor(cfg.dataset_name)):
        out.append(f'dataset_name={cfg.dataset_name!r} (not a simulated '
                   'benchmark: the JAX package serves no SINDy fit on real '
                   'data)')
    return out


def check_rollout_backend(backend: str, device) -> None:
    """An unknown backend name raises, and so do the kernels asked for
    ('pallas') on a device other than a CUDA card."""
    if backend not in ROLLOUT_BACKENDS:
        raise ValueError(f'rollout_backend={backend!r}; '
                         f'expected one of {ROLLOUT_BACKENDS}')
    if backend == 'pallas' and torch.device(device).type != 'cuda':
        raise ValueError("rollout_backend='pallas' runs the rollout "
                         'kernels, which need CUDA tensors; the device is '
                         f'{device}')


def _check_solver_settings(cfg: SINDyConfig, devices) -> None:
    """Unknown solver or backend names raise, and so do the kernels asked
    for on tensors they cannot take (on any of ``devices``)."""
    if cfg.insite_solver not in INSITE_SOLVERS:
        raise ValueError(f'insite_solver={cfg.insite_solver!r}; expected '
                         f'one of {INSITE_SOLVERS}')
    for device in devices:
        check_rollout_backend(cfg.rollout_backend, device)


class SINDyRegressor(CausalEstimator):
    """A-SINDy, A-WSINDy (``cfg.wsindy``) or INSITE (``cfg.insite``) on
    ``device``, in ``dtype`` (float32 unless given), its predictions sharded
    over ``mesh`` when one is given. Predictions come back as numpy, scaled
    like the dataset's outputs, ``[rows, T, 1]``."""

    def __init__(self, cfg: SINDyConfig, dataset_collection=None, *, device,
                 dtype=None, mesh=None):
        unserved = _unserved(cfg)
        if unserved:
            raise NotImplementedError(
                'not ported yet (ROADMAP.md): ' + ', '.join(unserved))
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        _check_solver_settings(cfg, (self.device,) + tuple(mesh or ()))
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
        return to_device(x, self.device, dtype or self.dtype)

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

    @span('fit')
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
        """One STLSQ per arm over the samples of that arm: [A, F]. Every
        arm's QR reduction comes from one call (`_qr_reduce_arms`) and one
        read to the host."""
        cfg = self.cfg
        triangles = to_host(_qr_reduce_arms(
            theta, xdot, ok, None if cfg.joint_model else arm,
            self._n_arms)).numpy()
        F = theta.shape[-1]
        return np.stack([stlsq_from_qr(t[:F, :F], t[:F, F],
                                       cfg.sindy_threshold, cfg.sindy_alpha,
                                       max_iter=cfg.max_stlsq_iter)[0]
                         for t in triangles])

    def _weak_solve_arms(self, systems, design):
        """Per arm, the candidate weak solves and the strong-form
        selection, in float64 on the host: [A, F]. Every arm's weak system
        and the strong-form design come over from the device first."""
        systems = [tuple(to_host(x).numpy() for x in sys_a)
                   for sys_a in systems]
        theta, xdot, ok, arm = (to_host(x).numpy() for x in design)
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

    @span('predict')
    def get_predictions(self, dataset) -> np.ndarray:
        if not self.insite:
            preds = self._global_rollout(dataset)
        else:
            preds = self._fine_tuned_rollout(dataset, projection_horizon=1)
        assert not np.any(np.isnan(preds)), 'Predictions contain NaN'
        return preds

    @span('predict')
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
        return to_host(preds).numpy()[..., None]

    @property
    def _plain(self) -> bool:
        """``rollout_backend='xla'``: the plain versions, no kernel."""
        return self.cfg.rollout_backend == 'xla'

    def _on_mesh(self, fn, *rows):
        """``fn(*rows)``; with a mesh, on each shard of the tensors among
        ``rows`` (the rest passed as they are), gathered on ``device``."""
        if self.mesh is None:
            return fn(*rows)
        at = [i for i, r in enumerate(rows) if torch.is_tensor(r)]
        shards, n = shard_rows([rows[i] for i in at], self.mesh)
        outs = []
        for shard in shards:
            args = list(rows)
            for i, x in zip(at, shard):
                args[i] = x
            outs.append(fn(*args))
        out = gather_rows(outs, n)
        if isinstance(out, tuple):
            return tuple(o.to(self.device) for o in out)
        return out.to(self.device)

    def _global_rollout(self, dataset) -> np.ndarray:
        prev, statics, arms, lengths = self._rollout_args(dataset)
        roll, _ = _rollouts(self.library, self._fold, self._plain)

        def run(prev_s, statics_s, arms_s):
            coefs = self._tensor(self.coefs).to(prev_s.device)
            return roll(coefs[None], prev_s[:, 0], statics_s, arms_s,
                        self.dt, y_clip=self._y_clip())

        preds = self._on_mesh(run, prev, statics, arms)
        return self._scaled_numpy(preds, lengths, dataset)

    def _fine_tune(self, dataset, projection_horizon: int, lam_grid=None):
        """Run the per-patient fine-tune; returns (preds [N, T],
        per-patient coefs [N, A, F]) on the device.

        With ``lam_grid`` (G values of the proximal penalty) the rows are
        stacked G times on the batch axis, copy g fine-tuned with
        ``lam_grid[g]``, all in one fine-tune: preds [G * N, T]. Otherwise
        every row takes ``cfg.lam``.

        ``cfg.insite_solver`` picks Levenberg-Marquardt or BFGS and
        ``cfg.rollout_backend`` kernels or plain versions, as the JAX
        package's `_fine_tune` dispatches (its fallback from a failed
        Pallas kernel to XLA is not ported: a kernel failure raises).

        With ``cfg.finetune_chunk`` (2048 by default with the degree-4
        library, whose Jacobian is [rows, T, up to A * 35]) the rows go
        through in chunks of that size, the last one padded by repeating
        its final row. Under a mesh each call is sharded (`_on_mesh`), and
        the chunk is rounded up to a multiple of the mesh size, so that a
        chunk splits evenly and the bound on the Jacobian holds per
        device."""
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
            lam = to_device(lam_grid, prev.device,
                            torch.float64).repeat_interleave(n_rows)
        active_idx = support(self.coefs)

        def solve(prev_c, statics_c, arms_c, lengths_c, lam_c):
            coefs = self._tensor(self.coefs).to(prev_c.device)
            args = (self.library, coefs, prev_c, statics_c, arms_c,
                    lengths_c, self.dt)
            kw = dict(lam=lam_c, projection_horizon=projection_horizon,
                      y_clip=self._y_clip(), active_idx=active_idx,
                      fold=self._fold)
            if cfg.insite_solver == 'bfgs':
                preds, coefs_out, _ = insite_finetune_predict(
                    *args, bfgs_maxiter=cfg.bfgs_maxiter, plain=self._plain,
                    **kw)
                return preds, coefs_out
            gn = (insite_gn_finetune_predict_jvp if self._plain
                  else insite_gn_finetune_predict)
            return gn(*args, gn_iters=cfg.gn_iters, **kw)

        chunk = cfg.finetune_chunk
        if chunk is None and cfg.ablation_more_complex_basis_functions:
            chunk = 2048
        n = prev.shape[0]
        if not chunk or n <= chunk:
            return self._on_mesh(solve, prev, statics, arms, lengths, lam)
        if self.mesh is not None:
            chunk = -(-chunk // len(self.mesh)) * len(self.mesh)
        preds_l, coefs_l = [], []
        for i in range(0, n, chunk):
            take = min(chunk, n - i)

            def padded(x):
                xs = x[i:i + take]
                if take < chunk:
                    xs = torch.cat([xs, xs[-1:].expand(chunk - take,
                                                       *xs.shape[1:])])
                return xs

            p, c = self._on_mesh(solve, padded(prev), padded(statics),
                                 padded(arms), padded(lengths),
                                 padded(lam) if torch.is_tensor(lam) else lam)
            preds_l.append(p[:take])
            coefs_l.append(c[:take])
        return torch.cat(preds_l), torch.cat(coefs_l)

    def get_fine_tuned_coefficients(self, dataset,
                                    projection_horizon: int = 1):
        """Per-patient fine-tuned coefficients [N, A, F], numpy."""
        _, coefs = self._fine_tune(dataset, projection_horizon)
        return to_host(coefs).numpy()

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


def _rollouts(library, fold: Optional[JointFold] = None,
              plain: bool = False):
    """(rollout, rollout with sensitivities) of a per-arm model over
    ``library`` or, given ``fold``, of the joint model it folds: both take
    (coefs, y0, statics, arms, dt, ...) as `ops/rollout.py`'s do after the
    library. ``plain``: the kernels' plain versions, on any device."""
    if fold is not None:
        if plain:
            return fold.rollout_plain, fold.rollout_with_sens_plain
        return fold.rollout, fold.rollout_with_sens
    if plain:
        return partial(batched_rollout_plain, library), \
            partial(rollout_with_sens_plain, library)
    return partial(batched_rollout, library), \
        partial(rollout_with_sens, library)


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


SUPPORT_THRESHOLD = 1e-3


def support(coefs) -> tuple:
    """The flat (arm * F + feature) coordinates the INSITE fine-tune moves,
    |coef| > `SUPPORT_THRESHOLD`, of host numpy global models [A, F], or
    their union over the models of [S, A, F]."""
    above = np.abs(coefs) > SUPPORT_THRESHOLD
    return tuple(int(i) for i in np.flatnonzero(
        above.reshape(-1, *above.shape[-2:]).any(axis=0)))


class _Reduced:
    """What every INSITE fine-tune shares: the problem in the Kr active
    coordinates, the one-step prefix each row is fitted on, and the rows
    that are not fine-tuned.

    global_coefs [A, F], or [B, A, F] a global model per row (the
    vectorized seed columns: each row its own seed's), with active_idx the
    union of the rows' supports (`support`, which may be empty); prev
    [B, T] observed y[0..T-1]; lengths [B]. A row fits its first
    ``lengths - projection_horizon`` one-step errors; a row with ``lengths
    <= projection_horizon`` (``skip``) is not fine-tuned and rolls out the
    full unmasked global model, the others a model masked to the support.
    With a global model per row, a row moves only its own support.
    """

    def __init__(self, global_coefs, prev, lengths, projection_horizon,
                 active_idx):
        dev, dtype = prev.device, prev.dtype
        self.prev = prev
        self.per_row = global_coefs.ndim == 3
        g_rows = global_coefs.to(dtype)
        if not self.per_row:
            g_rows = g_rows[None]                               # [1|B, A, F]
        self.g_rows = g_rows
        self.A, self.F = g_rows.shape[1:]
        self.K = self.A * self.F
        self.active_idx = tuple(active_idx)
        self.act = to_device(active_idx, dev, torch.int64)
        self.Kr = len(active_idx)
        self.B, self.T = prev.shape
        self.sparse_flat = (g_rows.abs() > SUPPORT_THRESHOLD).to(
            dtype).reshape(-1, self.K)
        self.g_red = g_rows.reshape(-1, self.K)[:, self.act]     # [1|B, Kr]
        # each row's own support among the union's coordinates
        self.own = (self.sparse_flat[:, self.act] > 0 if self.per_row
                    else None)                                  # [B, Kr]
        ph = projection_horizon
        self.prefix = (torch.arange(self.T - 1, device=dev)[None, :]
                       < (lengths - ph)[:, None])               # [B, T-1]
        self.n_mask = torch.clamp(self.prefix.to(dtype).sum(1), min=1.0)
        self.skip = lengths <= ph                               # [B]

    def to_full(self, c_red):
        """[B, Kr] active coordinates -> the masked model [B, A, F]."""
        c = torch.zeros((self.B, self.K), dtype=c_red.dtype,
                        device=c_red.device).index_copy(1, self.act, c_red)
        return (c * self.sparse_flat).reshape(self.B, self.A, self.F)

    def residuals(self, y):
        """The prefix's one-step errors prev[t+1] - y_t, 0 elsewhere."""
        return torch.where(self.prefix, self.prev[:, 1:] - y[:, :-1], 0.0)

    def masked(self, y, s):
        """(residuals r [B, T-1], their Jacobian J = -dy/dc [B, T-1, Kr])
        from a rollout y [B, T] and its sensitivities s [B, T, Kr]. With a
        global model per row, the coordinates of the union outside a row's
        own support get a zero Jacobian, as in the JAX package's full-K
        problem, so they stay at the row's global value and are masked out
        of its model."""
        J = torch.where(self.prefix[..., None], -s[:, :-1, :], 0.0)
        if self.per_row:
            J = torch.where(self.own[:, None, :], J, 0.0)
        return self.residuals(y), J

    # what the LM chain reads of the problem besides its sizes
    CHAIN_INPUTS = ('prev', 'prefix', 'n_mask', 'g_red', 'sparse_flat',
                    'act', 'own')

    def pinned(self, inputs: dict):
        """A copy of the problem that reads its `CHAIN_INPUTS` from
        ``inputs`` (name -> a tensor of the same shape, left out where the
        problem has None), which `refill` overwrites with those of a
        problem of the same shapes: the inputs of a captured chain
        (`_LMGraph`)."""
        pb = copy.copy(self)
        for name in self.CHAIN_INPUTS:
            setattr(pb, name, inputs.get(name))
        return pb

    def refill(self, other) -> None:
        for name in self.CHAIN_INPUTS:
            x = getattr(self, name)
            if x is not None:
                x.copy_(getattr(other, name))

    def predict(self, roll, c_red, statics, arms, dt, y_clip):
        """Every row's model and its rollout: (preds [B, T], coefs [B, A,
        F]). Skip rows roll out the FULL unmasked global model: to_full
        drops retained entries at or below `SUPPORT_THRESHOLD`."""
        coefs = torch.where(self.skip[:, None], self.g_red, c_red)
        coefs_full = torch.where(self.skip[:, None, None], self.g_rows,
                                 self.to_full(coefs))
        preds = roll(coefs_full, self.prev[:, 0], statics, arms, dt,
                     y_clip=y_clip)
        return preds, coefs_full


# The LM chain: what runs between two evaluations of the residuals and
# their Jacobian, written once for every path. Its state between two
# evaluations is an `_LMState`: ds [B] the objective's row scale, c [B, Kr]
# each row's best coefficients and obj [B] their objective, gram [B, Kr, Kr]
# and jtr [B, Kr] the scaled J^T J and J^T r at c, mu [B] the damping, and
# cand [B, Kr] the candidate the next evaluation is at. Keeping J^T J and
# J^T r, and not the Jacobian, keeps the state a few numbers a row.
_LMState = namedtuple('_LMState', 'ds c obj gram jtr mu cand')
# the proximal penalty's weight lam / K (a float, or [B] per row) as the
# chain reads it, beside the [Kr, Kr] identity
_LMTerms = namedtuple('_LMTerms', 'reg2 reg2_vec reg2_mat eye')


def _lm_terms(pb: _Reduced, lam) -> _LMTerms:
    eye = torch.eye(pb.Kr, dtype=pb.prev.dtype, device=pb.prev.device)
    if torch.is_tensor(lam):
        # per row; lam / K in float64, then rounded once, as for a float
        return _lm_row_terms((lam.to(torch.float64) / pb.K).to(pb.prev.dtype),
                             eye)
    reg2 = lam / pb.K                                           # reg_scale^2
    return _LMTerms(reg2, reg2, reg2, eye)


def _lm_row_terms(reg2, eye) -> _LMTerms:
    return _LMTerms(reg2, reg2[:, None], reg2[:, None, None], eye)


def _lm_objective(pb, t, ds, r, c):
    return ((r * ds[:, None]) ** 2).sum(1) + \
        t.reg2 * ((c - pb.g_red) ** 2).sum(1)


def _lm_normal(ds, r, J):
    """The scaled normal equations' J^T J [B, Kr, Kr] and J^T r [B, Kr]."""
    Js = J * ds[:, None, None]
    return (torch.einsum('btj,btk->bjk', Js, Js),
            torch.einsum('btj,bt->bj', Js, r * ds[:, None]))


def _lm_candidate(pb, t, st: _LMState) -> _LMState:
    """``st`` with its next candidate: a damped Gauss-Newton step from c,
    one batched [B, Kr, Kr] solve."""
    JtJ = st.gram + t.reg2_mat * t.eye[None]
    rhs = -st.jtr - t.reg2_vec * (st.c - pb.g_red)
    # solve_ex: no host sync for the error check; a non-finite row
    # yields a non-finite candidate, which the acceptance test rejects
    delta = torch.linalg.solve_ex(JtJ + st.mu[:, None, None] * t.eye[None],
                                  rhs[..., None])[0][..., 0]
    return st._replace(cand=st.c + delta)


def _lm_begin(pb, t, r0, J0) -> _LMState:
    """The chain before the loop, from the residuals and Jacobian of the
    global model."""
    mse0 = (r0 ** 2).sum(1) / pb.n_mask
    ds = 1.0 / torch.sqrt(2.5 * torch.clamp(mse0, min=1e-30) * pb.n_mask)
    c = pb.g_red.expand(pb.B, pb.Kr)
    mu = torch.full((pb.B,), 1e-3, dtype=r0.dtype, device=r0.device)
    return _lm_candidate(pb, t, _LMState(
        ds, c, _lm_objective(pb, t, ds, r0, c), *_lm_normal(ds, r0, J0), mu,
        None))


def _lm_step(pb, t, st: _LMState, r, J) -> _LMState:
    """One iteration's chain, from the residuals and Jacobian at the
    pending candidate: the candidate is kept only where it lowers the
    objective (deferred acceptance), then the next one."""
    obj = _lm_objective(pb, t, st.ds, r, st.cand)
    better = torch.isfinite(obj) & (obj < st.obj)
    gram, jtr = _lm_normal(st.ds, r, J)
    return _lm_candidate(pb, t, _LMState(
        st.ds, torch.where(better[:, None], st.cand, st.c),
        torch.where(better, obj, st.obj),
        torch.where(better[:, None, None], gram, st.gram),
        torch.where(better[:, None], jtr, st.jtr),
        torch.clamp(torch.where(better, st.mu * 0.3, st.mu * 10.0),
                    1e-8, 1e8), None))


def _lm_link(pb, t, st, outputs: list):
    """One link of the chain from an evaluation's outputs [y [B, T], s [B,
    T, Kr]]: `_lm_begin` where ``st`` is None, else `_lm_step` from
    ``st``. Returns the new state and the next evaluation's coefficients
    [B, A, F]. Empties ``outputs`` once they are masked, so that the
    step's peak memory holds no [B, T, Kr] tensor beyond its Jacobian."""
    r, J = pb.masked(*outputs)
    outputs.clear()
    st = _lm_begin(pb, t, r, J) if st is None else _lm_step(pb, t, st, r, J)
    return st, pb.to_full(st.cand)


def _lm_loop(pb, evaluate, link, gn_iters: int, out=None):
    """The chain's one loop: 1 + gn_iters evaluations, the first at the
    global model, each followed by ``link`` (`_lm_link`, or a graph's
    replay of it) from its outputs to the next coefficients. Returns the
    last state and coefficients."""
    st, coefs = None, pb.to_full(pb.g_red.expand(pb.B, pb.Kr))
    for _ in range(1 + gn_iters):
        outputs = list(evaluate(coefs, out))
        del coefs               # the evaluated model is not held in the link
        st, coefs = link(st, outputs)
    return st, coefs


class _LMArena:
    """Device memory that every captured chain of one device and dtype
    lays its tensors out in (`take`), each from the start: one flat tensor
    a dtype, sized for the largest chain. The chains run one at a time and
    a call fills what it reads first, so they can share it, and the
    memory held is one chain's. The chains also share one graph memory
    pool, as nothing in it outlives a replay."""

    # a tensor's first element on the caching allocator's alignment, so
    # that every kernel sees what it would see on a tensor of its own
    ALIGN = 512

    def __init__(self, device, sizes: dict):
        self.flat = {dt: torch.zeros(n, dtype=dt, device=device)
                     for dt, n in sizes.items()}
        self.pool = torch.cuda.graph_pool_handle()

    @classmethod
    def sizes(cls, tensors) -> dict:
        """The elements a dtype that ``tensors`` take laid out in order."""
        used = {}
        for x in tensors:
            used[x.dtype] = cls._next(used.get(x.dtype, 0), x) + x.numel()
        return used

    @classmethod
    def _next(cls, offset: int, x) -> int:
        step = max(cls.ALIGN // x.element_size(), 1)
        return -(-offset // step) * step

    def holds(self, sizes: dict) -> bool:
        return all(dt in self.flat and self.flat[dt].numel() >= n
                   for dt, n in sizes.items())

    def take(self, tensors) -> list:
        """Views of this memory shaped as ``tensors``, laid out in order
        from the start."""
        used, out = {}, []
        for x in tensors:
            off = self._next(used.get(x.dtype, 0), x)
            used[x.dtype] = off + x.numel()
            out.append(self.flat[x.dtype][off:off + x.numel()]
                       .view(x.shape))
        return out


class _LMGraph:
    """The LM chain of one shape (`_lm_graph_key`) captured as two CUDA
    graphs, each from the outputs (y, s) of a sensitivity launch to the
    coefficients of the next (`_lm_link`): the link before the loop and an
    iteration's. A call runs `_lm_loop` with a replay for each link, so
    its launches stay eager, one call of the launcher each.

    What the graphs read and write lies in an `_LMArena`: copies of the
    problem's chain inputs (`_Reduced.pinned`) and of a per-row penalty,
    the launch's output buffers ``ys``, the state (`_LMState`) and the
    next launch's coefficients. Each of them is written in a call before
    it is read: the call fills the inputs in place, the launches write
    their buffers, and each replay overwrites the state and coefficients
    in place, so that replays chain. ``warm``, the state and coefficients
    of one eager run of both links on the capturing stream, gives them
    their shapes."""

    def __init__(self, pb: _Reduced, t: _LMTerms, arena: _LMArena, ys,
                 warm):
        names = [n for n in pb.CHAIN_INPUTS if getattr(pb, n) is not None]
        per_row = torch.is_tensor(t.reg2)
        views = arena.take([getattr(pb, n) for n in names] +
                           ([t.reg2] if per_row else []) +
                           [*ys, warm[1], *warm[0]])
        self.pb = pb.pinned(dict(zip(names, views)))
        views = views[len(names):]
        # the identity is no input and no output, so it is the graph's
        # own: what lies in the arena, another chain's calls overwrite
        eye = t.eye.clone()
        self.t = (_lm_row_terms(views.pop(0), eye) if per_row
                  else t._replace(eye=eye))
        self.y, self.s, self.coefs = views[:3]
        self.state = _LMState(*views[3:])
        # cuBLAS keeps a workspace for each stream it has run on (32 MiB
        # on an H100): dropped before the captures, so that they allocate
        # theirs in the graphs' pool, and again after them, so that only
        # the graphs hold it, as torch's own graph trees do
        # (`torch._inductor.cudagraph_trees.clear_cublas_manager`)
        torch._C._cuda_clearCublasWorkspaces()
        self.begin = self._capture(None, arena.pool)
        self.step = self._capture(self.state, arena.pool)
        torch._C._cuda_clearCublasWorkspaces()

    def _capture(self, st, pool):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool, capture_error_mode='thread_local')
        try:
            new, coefs = _lm_link(self.pb, self.t, st, [self.y, self.s])
            for dst, src in zip(self.state, new):
                dst.copy_(src)
            self.coefs.copy_(coefs)
        finally:
            graph.capture_end()
        return graph

    def run(self, pb: _Reduced, t: _LMTerms, evaluate, gn_iters: int):
        """The loop of `_levenberg_marquardt` on ``pb``: each launch writes
        the graphs' buffers, and a replay follows it. Returns each row's
        best coefficients."""
        with torch.cuda.device(pb.prev.device):
            self.pb.refill(pb)
            if torch.is_tensor(t.reg2):
                self.t.reg2.copy_(t.reg2)
            st, _ = _lm_loop(pb, evaluate, self._replay, gn_iters,
                             (self.y, self.s))
            return st.c.clone()

    def _replay(self, st, outputs):
        """The link from the buffers the launch wrote, in place."""
        (self.begin if st is None else self.step).replay()
        return self.state, self.coefs


# The largest Jacobian, B * (T - 1) * Kr elements, whose chain is captured.
# Up to it a link's issue on the host outlasts its work on the device, by
# 3-4x at the north star's 1.7 M elements; from ~11 M up the two are even
# and a graph saves nothing (PERF.md: the probe of issue time against device
# time a link), while its buffers would hold ~7 bytes an element.
LM_GRAPH_MAX_JACOBIAN = 1 << 22
# captured chains kept a device, the least recently used dropped first
LM_GRAPHS_PER_DEVICE = 4
# device -> {`_lm_graph_key`: its `_LMGraph`}
_LM_GRAPHS = {}
# (device, dtype) -> the `_LMArena` of its chains
_LM_ARENAS = {}


def _lm_graph_key(pb: _Reduced, lam):
    """What a captured chain depends on besides the values it reads: the
    dtype, the sizes, a global model per row or not, and the penalty (a
    float's value is a constant of the graph; a per-row tensor an input).
    None where the chain is not captured: off the card, or a Jacobian
    over `LM_GRAPH_MAX_JACOBIAN`."""
    if pb.prev.device.type != 'cuda' or \
            pb.B * (pb.T - 1) * pb.Kr > LM_GRAPH_MAX_JACOBIAN:
        return None
    return (pb.prev.dtype, pb.B, pb.T, pb.A, pb.F, pb.Kr, pb.per_row,
            'per row' if torch.is_tensor(lam) else float(lam))


def _levenberg_marquardt(pb: _Reduced, evaluate, lam, gn_iters: int,
                         capture: bool = False):
    """The LM loop over the active coordinates: returns each row's best
    coefficients [B, Kr].

    Objective (the reference's f_to_min_func):
        prefix_mse(c) / (2.5 * prefix_mse(c_global)) + lam * mean((c - g)^2)
    ``evaluate(coefs [B, A, F], out=None) -> (y, s)``, a rollout and its
    sensitivities, evaluates the pending candidate once an iteration,
    which is kept only if it lowers the objective (deferred acceptance);
    the next step comes from a batched [B, Kr, Kr] solve.

    ``capture``: the evaluation is one sensitivity kernel launch, writing
    (y, s) into the pair ``out`` where given. Then the chain between two
    launches runs from CUDA graphs (`_LMGraph`) where `_lm_graph_key`
    allows: a shape's first call captures them after its eager run, and
    its later calls replay them around the same launches, the same
    operations on the same values.

    The float32 contractions below go through cuBLAS in full float32:
    PyTorch leaves TF32 off for matmuls (torch.backends.cuda.matmul.
    allow_tf32 is False) unless a caller turns it on, and callers of this
    function must not.

    Counts, while a profiler records: 'lm.chains' every link of the chain
    run (1 + gn_iters a call), 'lm.graph_hits' those replayed from a graph
    captured in an earlier call, 'lm.graph_captures' the captures.
    """
    t = _lm_terms(pb, lam)
    key = _lm_graph_key(pb, lam) if capture else None
    graphs = _LM_GRAPHS.get(pb.prev.device, {})
    count('lm.chains', 1 + gn_iters)
    if key in graphs:
        graphs.move_to_end(key)
        count('lm.graph_hits', 1 + gn_iters)
        return graphs[key].run(pb, t, evaluate, gn_iters)
    st, _ = _lm_loop(pb, evaluate, partial(_lm_link, pb, t), gn_iters)
    if key is not None:
        _lm_capture(pb, t, key)
    return st.c


def _lm_capture(pb: _Reduced, t: _LMTerms, key) -> None:
    """Capture ``pb``'s chain under ``key``, on a side stream after one
    eager run of both links there (`_lm_loop` of one iteration over zero
    buffers). Where the arena of its device and dtype is too small, a
    larger one replaces it, and the chains laid out in the old one are
    dropped, to be captured again on their next call."""
    dev, dtype = pb.prev.device, pb.prev.dtype
    graphs = _LM_GRAPHS.setdefault(dev, OrderedDict())
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ys = (torch.zeros_like(pb.prev),
                  pb.prev.new_zeros((pb.B, pb.T, pb.Kr)))
            st, coefs = _lm_loop(pb, lambda coefs, out: ys,
                                 partial(_lm_link, pb, t), 1)
            inputs = [getattr(pb, n) for n in pb.CHAIN_INPUTS]
            need = _LMArena.sizes(
                [x for x in inputs if x is not None] +
                ([t.reg2] if torch.is_tensor(t.reg2) else []) +
                [*ys, coefs, *st])
            arena = _LM_ARENAS.get((dev, dtype))
            if arena is None or not arena.holds(need):
                for k in [k for k in graphs if k[0] == dtype]:
                    del graphs[k]
                have = {} if arena is None else \
                    {dt: x.numel() for dt, x in arena.flat.items()}
                # the old arena goes before the new one is allocated
                _LM_ARENAS.pop((dev, dtype), None)
                del arena
                arena = _LM_ARENAS[(dev, dtype)] = _LMArena(
                    dev, {dt: max(n, have.get(dt, 0))
                          for dt, n in {**have, **need}.items()})
            graphs[key] = _LMGraph(pb, t, arena, ys, (st, coefs))
        torch.cuda.current_stream().wait_stream(side)
    count('lm.graph_captures')
    while len(graphs) > LM_GRAPHS_PER_DEVICE:
        graphs.popitem(last=False)


@span('predict')
def insite_gn_finetune_predict(library, global_coefs, prev, statics, arms,
                               lengths, dt, lam, projection_horizon: int,
                               gn_iters: int = 12, y_clip=None,
                               active_idx=(), fold=None):
    """INSITE fine-tune by Levenberg-Marquardt (`_levenberg_marquardt`)
    with the residual Jacobian from the rollout-with-sensitivities kernel,
    one launch an iteration, then one launch of the rollout kernel for
    every patient's model (the JAX package's
    `insite_gn_finetune_predict_pallas`). Rows with ``lengths <=
    projection_horizon`` keep, and roll out, the full unmasked global
    coefficients.

    global_coefs [A, F], or [B, A, F] a global model per row (see
    `_Reduced`); prev [B, T] observed y[0..T-1]; statics [B, S]; arms
    [B, T]; lengths [B]; lam a float, or a [B] tensor, a penalty per row
    (the lam grid's rows stacked); active_idx: the flat (arm * F +
    feature) coordinates to move, `support` of the global models. Returns
    (preds [B, T], coefs [B, A, F]). An empty ``active_idx`` moves
    nothing: one rollout at the global model, no loop, no sensitivity
    launch, no span 'predict.lm'.

    With ``fold`` (a `JointFold` of ``library``) the model is the joint
    one: global_coefs [1, F_joint], arms the combination index per step,
    and the loop works on the joint coordinates while the kernels run the
    folded per-arm model.

    The call is the tracer's span 'predict' and the loop its span
    'predict.lm', timed on the device too.
    """
    pb = _Reduced(global_coefs, prev, lengths, projection_horizon,
                  active_idx)
    roll, roll_sens = _rollouts(library, fold)
    if not pb.Kr:
        return pb.predict(roll, pb.g_red, statics, arms, dt, y_clip)
    # the graphs' buffers take one kernel launch: not a fold's, nor plain
    capture = fold is None and prev.device.type == 'cuda' and \
        pb.Kr <= kernel_bounds()['Kr']

    def evaluate(coefs, out=None):
        buffers = {} if out is None else {'out': out}
        return roll_sens(coefs, prev[:, 0], statics, arms, dt,
                         pb.active_idx, y_clip=y_clip, **buffers)

    with span('predict.lm', prev.device):
        c_best = _levenberg_marquardt(pb, evaluate, lam, gn_iters,
                                      capture=capture)
    return pb.predict(roll, c_best, statics, arms, dt, y_clip)


@span('predict')
def insite_gn_finetune_predict_jvp(library, global_coefs, prev, statics,
                                   arms, lengths, dt, lam,
                                   projection_horizon: int,
                                   gn_iters: int = 12, y_clip=None,
                                   active_idx=(), fold=None):
    """The Levenberg-Marquardt fine-tune of `insite_gn_finetune_predict`
    with the Jacobian from forward-mode autodiff through the plain
    rollout (`torch.func.vmap` of `torch.func.jvp` over the Kr coordinate
    basis: one rollout carries every tangent) and the final rollout by the
    plain version too: no kernel runs (the JAX package's
    `insite_gn_finetune_predict`, jvp through `lax.scan`, which its
    ``rollout_backend='xla'`` selects). Arguments and result as
    `insite_gn_finetune_predict`."""
    pb = _Reduced(global_coefs, prev, lengths, projection_horizon,
                  active_idx)
    roll, _ = _rollouts(library, fold, plain=True)
    if not pb.Kr:
        return pb.predict(roll, pb.g_red, statics, arms, dt, y_clip)

    def rollout(c_red):
        return roll(pb.to_full(c_red), prev[:, 0], statics, arms, dt,
                    y_clip=y_clip)

    tangents = torch.eye(pb.Kr, dtype=prev.dtype, device=prev.device)[
        :, None, :].expand(pb.Kr, pb.B, pb.Kr)

    def evaluate(coefs, out=None):
        # the masked model's active coordinates: to_full maps them back
        c_red = coefs.reshape(pb.B, pb.K)[:, pb.act]
        y, s = torch.func.vmap(lambda v: torch.func.jvp(
            rollout, (c_red,), (v,)))(tangents)
        return y[0], s.permute(1, 2, 0)                         # [B, T, Kr]

    with span('predict.lm', prev.device):
        c_best = _levenberg_marquardt(pb, evaluate, lam, gn_iters)
    return pb.predict(roll, c_best, statics, arms, dt, y_clip)


@span('predict')
def insite_finetune_predict(library, global_coefs, prev, statics, arms,
                            lengths, dt, lam, projection_horizon: int,
                            bfgs_maxiter=None, y_clip=None, active_idx=(),
                            fold=None, plain: bool = False):
    """INSITE fine-tune by BFGS (the JAX package's
    `insite_finetune_predict`, ``insite_solver='bfgs'``): every row's
    problem minimised by one lock-step batched BFGS (`ops/bfgs.py`), each
    objective-and-gradient evaluation one launch of the
    rollout-with-sensitivities kernel, then one launch of the rollout
    kernel for every patient's model.

    Objective (f_to_min_func):
        f(c) = sum_t r_t^2 / (n_mask * nc) + lam * sum_j (c_j - g_j)^2 / K
    with r_t = prev[t+1] - y_t(c) on the prefix t < lengths - ph, n_mask
    its length (at least 1), nc = max(2.5 * mse0, 1e-30) from the global
    model's prefix mean squared error, and K = A * F; its gradient comes
    from the sensitivities s = dy/dc,
        grad f = -2 sum_t r_t s_t / (n_mask * nc) + 2 lam (c - g) / K.

    The JAX package runs BFGS over all K coordinates; this runs it over
    the Kr active ones, and that is the same problem. The data term sees
    ``c * sparse_mask``, and the penalty's gradient is 0 at c = g, so at
    the start the gradient is exactly 0 on the masked coordinates. Then
    the search direction -H g, the step s and the gradient change y are 0
    there at every iteration, and the inverse-Hessian update keeps H's
    identity block on them and zeros between them and the active block:
    the masked coordinates never move and never enter the active ones'
    arithmetic. The iteration limit stays JAX's: ``bfgs_maxiter``, or
    200 * K of the full K when None. JAX's `minimize` ignores its ``tol``
    (gtol stays 1e-5 on the largest gradient entry), so no tolerance is
    taken here: `SINDyConfig.bfgs_tol` changes nothing, as in the JAX
    package.

    A row whose line search ends with its zoom failed (status 3) takes the
    masked global model; rows with ``lengths <= projection_horizon`` take
    the full unmasked global model. In float32 the objective's last digits
    stall most rows' line searches before the gradient reaches 1e-5, so
    most rows end with status 3, in the JAX package too (an EQ_4_D test
    set on the H100: 97.7 %; 0.5 % in float64). ``plain``: the plain versions of both
    kernels (``rollout_backend='xla'``). Arguments otherwise as
    `insite_gn_finetune_predict` (a [B] ``lam``, per-row globals and
    ``fold`` included). Returns (preds [B, T], coefs [B, A, F], the
    `BFGSResult` of the reduced problem; None for an empty ``active_idx``,
    which runs no BFGS and rolls out the global model)."""
    pb = _Reduced(global_coefs, prev, lengths, projection_horizon,
                  active_idx)
    roll, roll_sens = _rollouts(library, fold, plain)
    if not pb.Kr:
        return (*pb.predict(roll, pb.g_red, statics, arms, dt, y_clip), None)
    if torch.is_tensor(lam):
        lam = lam.to(prev.dtype)
        lam_col = lam[:, None]
    else:
        lam_col = lam
    nc = None

    def fun_and_grad(c_red):
        nonlocal nc
        r, J = pb.masked(*roll_sens(pb.to_full(c_red), prev[:, 0], statics,
                                    arms, dt, pb.active_idx, y_clip=y_clip))
        mse = (r * r).sum(1) / pb.n_mask
        if nc is None:
            # the first evaluation is at the global model
            nc = torch.clamp(mse * 2.5, min=1e-30)
        d = c_red - pb.g_red
        f = mse / nc + lam * ((d * d).sum(1) / pb.K)
        g = 2.0 * torch.einsum('bt,btk->bk', r, J) \
            / (pb.n_mask * nc)[:, None] + lam_col * (2.0 * d / pb.K)
        return f, g

    maxiter = 200 * pb.K if bfgs_maxiter is None else bfgs_maxiter
    res = minimize_bfgs(fun_and_grad, pb.g_red.expand(pb.B, pb.Kr),
                        maxiter=maxiter)
    c_red = torch.where((res.status == 3)[:, None], pb.g_red, res.x_k)
    preds, coefs = pb.predict(roll, c_red, statics, arms, dt, y_clip)
    return preds, coefs, res
