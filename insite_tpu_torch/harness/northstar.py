"""The north-star pipeline: simulate an EQ_4 cohort, discover one ODE per
arm, fine-tune it per patient (INSITE) and score the factual fit.

Stages, each a span of the program's tracer (`utils/profiling.py`) whose
host duration is the stage's time:

  sim+design+QR  simulate the cohort (span 'collection'), build the
                 smoothed-finite-difference design matrix and reduce both
                 arms by QR on the device in one pass over it (span 'fit',
                 the QR 'fit.qr'); only the two (F+1) x (F+1) triangles go
                 to the host, in one read,
  STLSQ          the F x F thresholding iteration on the host in float64
                 (span 'fit', the iteration 'fit.stlsq'),
  fine-tune      the Levenberg-Marquardt loop (gn_iters + 1 launches of the
                 rollout-with-sensitivities kernel, one rollout launch;
                 span 'predict', the loop 'predict.lm'), ending at a
                 device synchronisation,
  metric         the normalised factual RMSE, reduced on the device (span
                 'metric').

`simulate_cohort` and `discover_and_finetune` are the two halves, so a
cohort from elsewhere (for example the JAX package's) can be fed to the
later stages. With ``device_time_repeats`` R > 0, sim+design+QR and the
fine-tune each run R more times after the timed pass, on the inputs
already on the device, and the fastest of each is reported: the device
times that `insite_tpu_torch.bench` prints.
"""

from __future__ import annotations

import numpy as np
import torch

from insite_tpu_torch.core.constants import MAX_VALUE, STANDARD_DT
from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.discovery.stlsq import _qr_reduce_arms, stlsq_from_qr
from insite_tpu_torch.models.sindy import (_eq4_design,
                                           check_rollout_backend,
                                           insite_gn_finetune_predict,
                                           insite_gn_finetune_predict_jvp,
                                           support)
from insite_tpu_torch.sim import pkpd
from insite_tpu_torch.utils.profiling import span, to_device, to_host

LIBRARY = PolynomialLibrary(n_inputs=3)      # [y, c0, c1]
INPUT_NAMES = ['x0', 'u0', 'u1']


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


@span('collection')
def simulate_cohort(n: int, seed: int, equation_name: str = 'EQ_4_D',
                    conf_coeff: float = 2.0, seq_length: int = 60, *,
                    device, dtype=None):
    """Draw parameters and the factual cohort from a generator seeded with
    ``seed`` on ``device``. Returns (vol [n, seq_length], statics [n, 2],
    treat [n, seq_length], lengths [n])."""
    dtype = resolve_float(dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    add_noise = equation_name.split('_')[-1] in ('B', 'C', 'D')
    params = pkpd.generate_params(n, conf_coeff=conf_coeff, window_size=15,
                                  lag=0, generator=gen,
                                  equation=pkpd.Equation[equation_name],
                                  device=device, dtype=dtype)
    vol, treat, lengths = pkpd._simulate_factual_full(
        params, gen, seq_length, add_noise, dtype=dtype)
    statics = torch.stack([params['observed_static_c_0'],
                           params['observed_static_c_1']], dim=-1)
    return vol, statics, treat, lengths


@span('fit')
def design_qr(cohort, library=LIBRARY):
    """EQ_4 fit semantics (offset 1, smoothed 4th-order finite differences)
    and the per-arm QR reduction: returns the triangles
    ``[R_a | Q_a^T y_a]`` [2, F + 1, F + 1] of arms 0 and 1."""
    vol, statics, treat, lengths = cohort
    eff_len = torch.clamp(lengths - 1, min=2)
    theta, y, ok, arm = _eq4_design(vol, statics, treat, eff_len,
                                    STANDARD_DT, library=library,
                                    smooth=True, fd_order=4)
    return _qr_reduce_arms(theta, y, ok, arm, 2)


def _factual_rmse(preds, vol, lengths):
    """Normalised factual RMSE in % (orig: per-timestep mean, then sqrt;
    all: pooled), reduced on the device."""
    T = preds.shape[1]
    active = (torch.arange(T, device=preds.device)[None, :]
              < lengths[:, None]).to(preds.dtype)
    err2 = torch.where(active > 0, (preds - vol[:, 1:]) ** 2, 0.0)
    mse_orig = (err2.sum(0) / torch.clamp(active.sum(0), min=1.0)).mean()
    rmse_orig = torch.sqrt(mse_orig) / MAX_VALUE * 100.0
    rmse_all = torch.sqrt(err2.sum() / active.sum()) / MAX_VALUE * 100.0
    return rmse_orig, rmse_all


def _finetune_fn(rollout_backend: str, device):
    """The Levenberg-Marquardt fine-tune ``rollout_backend`` selects, as
    `SINDyConfig.rollout_backend` does: 'auto' the kernels on CUDA
    tensors and their plain versions on the CPU, 'pallas' the kernels
    (CUDA tensors required), 'xla' jvp through the plain rollout."""
    check_rollout_backend(rollout_backend, device)
    if rollout_backend == 'xla':
        return insite_gn_finetune_predict_jvp
    return insite_gn_finetune_predict


def _fastest(name: str, fn, repeats: int, device) -> float:
    """The least host duration, in seconds, of ``repeats`` calls of
    ``fn``, each a span ``name`` between two device synchronisations."""
    times = []
    for _ in range(repeats):
        _sync(device)
        with span(name) as s:
            fn()
            _sync(device)
        times.append(s.seconds)
    return min(times)


def discover_and_finetune(cohort, threshold: float = 0.1, alpha: float = 0.5,
                          lam: float = 10.0, gn_iters: int = 12,
                          projection_horizon: int = 1,
                          max_stlsq_iter: int = 100,
                          rollout_backend: str = 'auto',
                          device_time_repeats: int = 0,
                          simulate=None) -> dict:
    """Design + QR, host STLSQ, INSITE fine-tune and the factual RMSE on a
    cohort ``(vol, statics, treat, lengths)`` of tensors on one device.
    The first stage's time also covers any device work on the cohort still
    pending when this is called.

    With ``device_time_repeats`` R > 0, after the timed stages the first
    stage and the fine-tune each run R more times on the same inputs, and
    the least of each is returned as ``device_sim_design_s`` and
    ``device_finetune_s``; the repeats change no result. ``simulate``
    (a callable that draws the cohort again) makes a repeat of the first
    stage simulate too; without it the repeat builds the design and QR of
    ``cohort``."""
    vol, statics, treat, lengths = cohort
    device, dtype = vol.device, vol.dtype
    finetune_fn = _finetune_fn(rollout_backend, device)
    seq_length = vol.shape[1]
    with span('fit') as sim_design:
        triangles = to_host(design_qr(cohort)).numpy()
    F = triangles.shape[-1] - 1

    with span('fit') as stlsq:
        # cast to the compute dtype, as the JAX package does
        coefs = np.stack([
            stlsq_from_qr(t[:F, :F], t[:F, F], threshold, alpha,
                          max_iter=max_stlsq_iter)[0]
            for t in triangles]).astype(
                torch.empty((), dtype=dtype).numpy().dtype)

    active_idx = support(coefs)
    prev = vol[:, :-1]
    arms = treat[:, :seq_length - 1].to(torch.int32)
    coefs_t = to_device(coefs, device, dtype)

    def finetune():
        return finetune_fn(
            LIBRARY, coefs_t, prev, statics, arms, lengths, STANDARD_DT,
            lam=lam, projection_horizon=projection_horizon,
            gn_iters=gn_iters, y_clip=None, active_idx=active_idx)

    with span('predict') as fine_tune:
        preds, _ = finetune()
        _sync(device)

    with span('metric') as metric:
        rmse_orig, rmse_all = (float(to_host(v)) for v in
                               _factual_rmse(preds, vol, lengths))

    device_times = {}
    if device_time_repeats > 0:
        device_times['device_sim_design_s'] = _fastest(
            'fit', lambda: design_qr(simulate() if simulate else cohort),
            device_time_repeats, device)
        device_times['device_finetune_s'] = _fastest(
            'predict', finetune, device_time_repeats, device)
    t_sim_design, t_stlsq = sim_design.seconds, stlsq.seconds
    t_finetune, t_metric = fine_tune.seconds, metric.seconds

    eq_strs = [LIBRARY.pretty_equation(coefs[a], INPUT_NAMES)
               for a in range(2)]
    return {
        **device_times,
        'coefs': coefs,
        'preds': preds,
        'global_equation_string': ' | '.join(
            f'Treatment {a}: x_dot = {s}' for a, s in enumerate(eq_strs)),
        'rmse_orig': rmse_orig, 'rmse_all': rmse_all,
        't_sim_design': t_sim_design, 't_stlsq': t_stlsq,
        't_finetune': t_finetune, 't_metric': t_metric,
        'total': t_sim_design + t_stlsq + t_finetune + t_metric,
    }


def fused_northstar(n_train: int, seed: int = 0,
                    equation_name: str = 'EQ_4_D', conf_coeff: float = 2.0,
                    seq_length: int = 60, threshold: float = 0.1,
                    alpha: float = 0.5, lam: float = 10.0,
                    gn_iters: int = 12, projection_horizon: int = 1,
                    max_stlsq_iter: int = 100, rollout_backend='auto',
                    dtype=None, device_time_repeats: int = 0, *,
                    device) -> dict:
    """The whole north-star workload (simulate + discover + fine-tune) on
    ``device``. Returns the global coefficients and equation string, the
    fine-tuned predictions, the factual normalised RMSEs (%) and per-stage
    wall times in seconds; with ``device_time_repeats`` R > 0 also the
    least of R further runs of sim+design+QR (``device_sim_design_s``)
    and of the fine-tune (``device_finetune_s``), on the inputs already on
    the device. ``rollout_backend`` stands where the JAX function has
    ``use_pallas`` ('auto', 'pallas' or 'xla', as
    `SINDyConfig.rollout_backend`); a kernel that fails to build or launch
    fails the call."""

    def simulate():
        return simulate_cohort(n_train, seed, equation_name, conf_coeff,
                               seq_length, device=device, dtype=dtype)

    _sync(device)
    with span('collection') as sim:      # the rest is timed in the next stage
        cohort = simulate()
    t_sim = sim.seconds
    r = discover_and_finetune(cohort, threshold, alpha, lam, gn_iters,
                              projection_horizon, max_stlsq_iter,
                              rollout_backend, device_time_repeats,
                              simulate)
    r['t_sim_design'] += t_sim
    r['total'] += t_sim
    return r
