"""Vectorized seed columns: every seed of one (dataset, method) main-table
column (simulate cohort -> design -> discovery -> INSITE fine-tune ->
counterfactual evaluation) as one batch on the device.

The JAX package vmaps its per-seed pipeline over PRNG keys
(`insite_tpu.harness.vectorized`). Here the seeds are stacked on the batch
axis instead: each seed draws its cohorts from its own generator and fits
its own global model (F <= 7 features an arm), every seed's test rows are
concatenated into one batch whose per-row coefficient table gives each row
its own seed's model, and the fine-tune and the rollouts run once for the
whole column, through the same two kernels as the standard path. The
fine-tune moves the union of the seeds' supports (`models.sindy.support`;
an empty union is one rollout, as in `insite_gn_finetune_predict`). The
metrics are then taken per seed.

EQ_4 cohorts are drawn as `PkpdDatasetCollection` draws its subsets (a
fresh generator seeded with the seed for each), so a seed's cohort here is
the standard path's, bit for bit. Tumor-family (cancer_sim, EQ_5) cohorts
draw their parameters from a ``torch.Generator`` with the distributions of
the JAX package's `_tumor_params_jax`, so they match the reference in
distribution, not in samples. Each family's pipeline is split into the
draws and a core that takes them, so parity tests feed the core the JAX
package's cohorts.

Discovery is the JAX package's masked-ridge `stlsq` (normal equations in
float64 whatever the compute dtype) or, for wsindy, `weak_sindy_fit_select`
(float64 on the host), not the standard path's QR STLSQ, so a seed's
coefficients agree with the standard path's to the solver's tolerance, not
bitwise.

The tracer's spans (`utils/profiling.py`): 'collection' (`tumor_draws`,
`tumor_cohort`), 'fit' (`discover_column`), 'predict' (`evaluate_column`).
"""

from __future__ import annotations

import numpy as np
import torch

from insite_tpu_torch.core.constants import MAX_VALUE, STANDARD_DT
from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.discovery.stlsq import stlsq
from insite_tpu_torch.discovery.wsindy import weak_sindy_fit_select
from insite_tpu_torch.harness.results import ci
from insite_tpu_torch.models.sindy import (SINDyConfig, _eq4_design,
                                           _tumor_design,
                                           insite_gn_finetune_predict,
                                           support, wsindy_grid)
from insite_tpu_torch.ops.rollout import batched_rollout
from insite_tpu_torch.parallel import seed_blocks
from insite_tpu_torch.sim import pkpd
from insite_tpu_torch.sim.cancer import (CANCER_STAGE_OBSERVATIONS,
                                         TUMOUR_SIZE_DISTRIBUTIONS)
from insite_tpu_torch.sim.tumor import (TUMOUR_DEATH_THRESHOLD,
                                        calc_diameter, calc_volume,
                                        cf_factual_core, cf_one_step_rows,
                                        cf_seq_rows, factual_core)
from insite_tpu_torch.utils.profiling import span, to_device, to_host

TUMOR_VARIANTS = {
    # patient_type_choices, beta_c_noise, extra_noise
    'cancer_sim': ((1, 2, 3), True, False),
    'EQ_5_A': ((1,), False, False),
    'EQ_5_B': ((1,), False, True),
    'EQ_5_C': ((1, 2, 3), False, True),
    'EQ_5_D': ((1, 2, 3), True, True),
}
WINDOW_SIZE = 15


# ---------------------------------------------------------------------------
# cohorts: each seed's train rows and both test sets, flat
#
# A cohort is a dict of 'train': (volumes [n, T], treatments [n, T] (EQ_4;
# the tumor family: per-step arms [n, T-1]), lengths [n], statics [n, S])
# and 'one_step' / 'n_step': (rows [N, W], arms [N, W-1], lengths [N],
# statics [N, S], valid [N] or None), rows ordered [patient, prefix,
# branch or plan].

def _flat_rows(rows, actions, lengths, statics, valid=None):
    """[n, R, W] row blocks and per-patient statics [n, S] -> flat rows,
    integer arms of every transition, lengths, the statics repeated over
    each patient's rows, and ``valid``."""
    n, R, W = rows.shape
    arms = actions.reshape(n * R, W)[:, :-1].to(torch.int64)
    return (rows.reshape(n * R, W), arms, lengths.reshape(n * R),
            statics.repeat_interleave(R, dim=0),
            None if valid is None else valid.reshape(n * R))


def eq4_cohort(seed: int, equation_str: str, n_train: int, n_test: int,
               seq_length: int, conf_coeff: float, projection_horizon: int,
               noise_scale: float = 1.0, *, device, dtype=None) -> dict:
    """One seed's EQ_4 cohorts, each drawn from a fresh generator seeded
    with ``seed``, as `PkpdDatasetCollection` draws its subsets: the same
    parameters, trajectories and observation noise bit for bit."""
    equation = pkpd.Equation[equation_str]
    add_noise = pkpd._add_noise(equation)
    dtype = resolve_float(dtype)

    def draw(n, mode):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = pkpd.generate_params(n, conf_coeff=conf_coeff,
                                      window_size=WINDOW_SIZE, lag=0,
                                      generator=gen, equation=equation,
                                      device=device, dtype=dtype)
        params['observation_noise'] = \
            params['observation_noise'] * noise_scale
        statics = torch.stack([params['observed_static_c_0'],
                               params['observed_static_c_1']], dim=-1)
        if mode == 'factual':
            vol, treat, lengths = pkpd._simulate_factual_full(
                params, gen, seq_length, add_noise, dtype=dtype)
            return vol, treat, lengths, statics
        if mode == 'one_step':
            out = pkpd._simulate_cf_1_step_full(params, gen, seq_length,
                                                add_noise, dtype=dtype)
        else:
            out = pkpd._simulate_cf_seq_full(
                params, gen, seq_length, projection_horizon,
                'sliding_treatment', add_noise, dtype=dtype)
        return _flat_rows(*out, statics)

    return {'train': draw(n_train, 'factual'),
            'one_step': draw(n_test, 'one_step'),
            'n_step': draw(n_test, 'n_step')}


def _truncated_normal(gen, lower, upper, shape, dtype, device):
    """`jax.random.truncated_normal`'s construction from a generator: a
    uniform between erf(lower / sqrt 2) and erf(upper / sqrt 2) through
    sqrt 2 * erfinv, clipped inside (lower, upper)."""
    lower = to_device(lower, device, dtype)
    upper = to_device(upper, device, dtype)
    sqrt2 = float(np.sqrt(2.0))
    a, b = torch.erf(lower / sqrt2), torch.erf(upper / sqrt2)
    u = a + (b - a) * torch.rand(shape, generator=gen, dtype=dtype,
                                 device=device)
    out = sqrt2 * torch.erfinv(u)
    inf = to_device(float('inf'), device, dtype)
    return torch.minimum(torch.maximum(out, torch.nextafter(lower, inf)),
                         torch.nextafter(upper, -inf))


def _tumor_params(gen, n: int, chemo_coeff: float, radio_coeff: float,
                  patient_type_choices=(1, 2, 3), beta_c_noise=True, *,
                  device, dtype):
    """The patient parameters of `cancer.get_standard_params` drawn from a
    generator with the distributions of the JAX package's
    `_tumor_params_jax`: the stage from its categorical, a truncated
    normal log diameter, (alpha, rho) as the first positive pair of 16
    correlated normal draws, the patient type and, optionally, a truncated
    normal beta_c. Returns (params: `tumor.PARAM_KEYS` [n] tensors,
    patient types [n])."""
    kw = dict(dtype=dtype, device=device)
    stages = sorted(TUMOUR_SIZE_DISTRIBUTIONS)
    total = sum(CANCER_STAGE_OBSERVATIONS.values())
    probs = to_device([CANCER_STAGE_OBSERVATIONS[s] / total
                       for s in stages], device, torch.float64)
    dist = np.array([TUMOUR_SIZE_DISTRIBUTIONS[s] for s in stages])
    mus, sigmas = (to_device(dist[:, i], device, dtype) for i in (0, 1))
    lbs = to_device((np.log(dist[:, 2]) - dist[:, 0]) / dist[:, 1], device,
                    dtype)
    ubs = to_device((np.log(dist[:, 3]) - dist[:, 0]) / dist[:, 1], device,
                    dtype)
    stage = torch.multinomial(probs, n, replacement=True, generator=gen)
    tn = _truncated_normal(gen, lbs[stage], ubs[stage], (n,), dtype, device)
    initial_volumes = calc_volume(torch.exp(tn * sigmas[stage] + mus[stage]))

    alpha_params, rho_params = (0.0398, 0.168), (7e-5, 7.23e-3)
    corr = 0.87
    cov = to_device(
        [[alpha_params[1] ** 2, corr * alpha_params[1] * rho_params[1]],
         [corr * alpha_params[1] * rho_params[1], rho_params[1] ** 2]],
        device, dtype)
    L = torch.linalg.cholesky(cov)
    mean = to_device([alpha_params[0], rho_params[0]], device, dtype)
    z = torch.randn((n, 16, 2), generator=gen, **kw)
    cand = mean + torch.einsum('ngk,jk->ngj', z, L)
    ok = (cand > 0.0).all(dim=-1)                           # [n, 16]
    first = torch.argmax(ok.to(torch.int8), dim=1)
    pick = cand[torch.arange(n, device=device), first]
    pick = torch.where(ok.any(dim=1)[:, None], pick, mean)

    choices = to_device(patient_type_choices, device, torch.int64)
    ptypes = choices[torch.randint(0, len(patient_type_choices), (n,),
                                   generator=gen, device=device)]
    chemo_adj = torch.where(ptypes < 3, 0.0, 0.1).to(dtype)
    radio_adj = torch.where(ptypes > 1, 0.0, 0.1).to(dtype)
    alpha = pick[:, 0] + alpha_params[0] * radio_adj
    beta_c_params = (0.028, 0.0007)
    beta_c_adj = beta_c_params[0] * chemo_adj
    if beta_c_noise:
        lo = (0.0 - beta_c_params[0]) / beta_c_params[1]
        t = _truncated_normal(gen, lo, float('inf'), (n,), dtype, device)
        beta_c = beta_c_params[0] + beta_c_params[1] * t + beta_c_adj
    else:
        beta_c = beta_c_params[0] + beta_c_adj

    d_max = calc_diameter(TUMOUR_DEATH_THRESHOLD)

    def full(v):
        return torch.full((n,), v, **kw)
    return {'initial_volumes': initial_volumes.to(dtype), 'alpha': alpha,
            'rho': pick[:, 1], 'beta': alpha / 10.0, 'beta_c': beta_c,
            'K': full(calc_volume(30.0)),
            'chemo_sigmoid_intercepts': full(d_max / 2.0),
            'radio_sigmoid_intercepts': full(d_max / 2.0),
            'chemo_sigmoid_betas': full(chemo_coeff / d_max),
            'radio_sigmoid_betas': full(radio_coeff / d_max)}, ptypes


@span('collection')
def tumor_draws(seed: int, dataset_name: str, n_train: int, n_test: int,
                seq_length: int, coeff: float, projection_horizon: int, *,
                device, dtype=None) -> dict:
    """Every random number of one seed's tumor-family column, from one
    generator seeded with ``seed``, in the JAX package's roles
    (`_tumor_one_seed`): the training cohort's parameters, patient types
    and factual draws (noise, recovery, chemo_rv, radio_rv) and, on the
    noisy EQ_5 variants, its observation noise; the test cohort's
    parameters, patient types and draws, its noise ph steps longer; and the
    observation noise of the 1-step and the n-step rows."""
    dtype = resolve_float(dtype)
    ptc, bcn, extra = TUMOR_VARIANTS[dataset_name]
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=dtype, device=device)
    T, ph = seq_length, projection_horizon

    def factual_rvs(n, noise_len):
        return {'noise': 0.01 * torch.randn((n, noise_len), **kw),
                'recovery': torch.rand((n, T), **kw),
                'chemo_rv': torch.rand((n, T), **kw),
                'radio_rv': torch.rand((n, T), **kw)}

    out = {}
    for tag, n, noise_len in (('train', n_train, T), ('test', n_test,
                                                      T + ph)):
        out[f'{tag}_params'], out[f'{tag}_ptypes'] = _tumor_params(
            gen, n, coeff, coeff, ptc, bcn, device=device, dtype=dtype)
        out[f'{tag}_rvs'] = factual_rvs(n, noise_len)
    out['train_noise'] = out['one_step_noise'] = out['n_step_noise'] = None
    if extra:
        out['train_noise'] = 0.01 * torch.randn((n_train, T), **kw)
        out['one_step_noise'] = 0.01 * torch.randn(
            (n_test * (T - 1) * 4, T), **kw)
        out['n_step_noise'] = 0.01 * torch.randn(
            (n_test * (T - 1) * 2 * ph, T + ph), **kw)
    return out


@span('collection')
def tumor_cohort(draws: dict, seq_length: int, projection_horizon: int,
                 include_dosage: bool = False) -> dict:
    """A tumor-family seed's cohorts from its draws, as the JAX package's
    `_tumor_one_seed` builds them over the simulator cores: the factual
    training cohort, and the test cohort's shared factual branch with its
    1-step rows (4 treatment options a prefix) and n-step rows (2 ph
    single-treatment plans a prefix). Statics are the patient type and,
    with ``include_dosage`` (EQ_5), the t = 0 chemo dosage, identically 0."""
    T, ph = seq_length, projection_horizon
    fact = factual_core(draws['train_params'], draws['train_rvs'], T,
                        WINDOW_SIZE, 0)
    vol = fact['cancer_volume']
    dtype, dev = vol.dtype, vol.device
    if draws['train_noise'] is not None:
        vol = vol + draws['train_noise']
    arms = (fact['chemo_application'][:, :-1] +
            2.0 * fact['radio_application'][:, :-1]).to(torch.int64)
    statics = draws['train_ptypes'].to(dtype)[:, None]
    if include_dosage:
        statics = torch.cat([statics,
                             fact['chemo_dosage'][:, :1].to(dtype)], dim=-1)
    out = {'train': (vol, arms, fact['sequence_lengths'], statics)}

    params_t, rvs_t = draws['test_params'], draws['test_rvs']
    fact_t = cf_factual_core(params_t, rvs_t, T, WINDOW_SIZE, 0)
    n_test = fact_t['volumes'].shape[0]
    stat_t = draws['test_ptypes'].to(dtype)[:, None]
    if include_dosage:
        # the cf rows prepend a zero dosage step
        stat_t = torch.cat([stat_t, torch.zeros_like(stat_t)], dim=-1)

    vol_r, ch_r, ra_r, sl, valid = cf_one_step_rows(params_t, fact_t,
                                                    rvs_t['noise'], T)
    R = (T - 1) * 4
    rows = vol_r.reshape(n_test * R, T)
    if draws['one_step_noise'] is not None:
        rows = rows + draws['one_step_noise']
    out['one_step'] = _flat_rows(rows.reshape(n_test, R, T),
                                 (ch_r + 2.0 * ra_r).reshape(n_test, R, T),
                                 sl, stat_t, valid.to(dtype))

    eye = torch.eye(ph, dtype=dtype, device=dev)
    plans = torch.stack([torch.cat([eye, 0 * eye]),
                         torch.cat([0 * eye, eye])], dim=-1)
    plans = plans[None, None].expand(n_test, T - 1, 2 * ph, ph, 2)
    vol_r, ch_r, ra_r, _, sl, valid = cf_seq_rows(params_t, fact_t, plans,
                                                  rvs_t['noise'], T, ph)
    R2, W = (T - 1) * 2 * ph, T + ph
    rows = vol_r.reshape(n_test * R2, W)
    if draws['n_step_noise'] is not None:
        rows = rows + draws['n_step_noise']
    out['n_step'] = _flat_rows(rows.reshape(n_test, R2, W),
                               (ch_r + 2.0 * ra_r).reshape(n_test, R2, W),
                               sl, stat_t, valid.to(dtype))
    return out


# ---------------------------------------------------------------------------
# the column core

def _stack(cohorts, subset):
    """One subset of every seed's cohort, concatenated seed-major."""
    parts = list(zip(*(c[subset] for c in cohorts)))
    return tuple(None if p[0] is None else torch.cat(p) for p in parts)


def _discover(cohorts, library, n_arms, eq4, method, threshold, alpha, dt):
    """Every seed's global model [S, A, F], numpy float64: the family's
    design over the stacked training cohorts, then per arm the
    masked-ridge `stlsq` batched over seeds or, for wsindy, the weak
    threshold-grid fit of each seed."""
    S = len(cohorts)
    vol, arms, lengths, statics = _stack(cohorts, 'train')
    n = vol.shape[0] // S
    if eq4:
        arms = arms[:, :-1].to(torch.int64)
        lengths = torch.clamp(lengths - 1, min=2)
        design = _eq4_design(vol, statics, arms, lengths, dt,
                             library=library, smooth=True, fd_order=4)
    else:
        design = _tumor_design(vol, statics, arms, lengths, dt,
                               library=library)
    theta, xdot, ok, arm = (x.reshape(S, -1, *x.shape[1:]) for x in design)
    weights = [(ok & (arm == a)).to(theta.dtype) for a in range(n_arms)]
    if method != 'wsindy':
        return np.stack([stlsq(theta, xdot, threshold, alpha,
                               sample_weight=w)[0] for w in weights],
                        axis=1)
    cfg = SINDyConfig(sindy_threshold=threshold)
    grid, alphas = wsindy_grid(cfg)
    coefs = np.zeros((S, n_arms, theta.shape[-1]))
    for s in range(S):
        rows = slice(s * n, (s + 1) * n)
        for a in range(n_arms):
            coefs[s, a] = weak_sindy_fit_select(
                vol[rows], statics[rows], lengths[rows], library, dt, grid,
                theta[s], xdot[s], weights[a][s], alphas=alphas,
                select_tol=cfg.wsindy_select_tol,
                trajectory_mask=(arms[rows, 0] == a))
    return coefs


def _predict(library, coefs, rows, arms, lengths, statics, dt, *, insite,
             lam, ph, gn_iters, y_clip, union, group=None):
    """Predictions [R, W-1] of the stacked rows of S seeds (seed-major,
    R / S rows a seed), each seed's rows with its own model ``coefs``
    [S, A, F]. INSITE fine-tunes each row over its first lengths - ``ph``
    steps, in the coordinates ``union`` (the union of the column's
    supports, which may be empty); with ``group`` = P it fine-tunes the
    first of every P consecutive rows (the branches or plans of one
    prefix) and rolls all P out with that row's model."""
    S = coefs.shape[0]
    prev = rows[:, :-1]
    per_seed = rows.shape[0] // S
    if not insite:
        return batched_rollout(library, coefs.repeat_interleave(
            per_seed, dim=0), prev[:, 0], statics, arms, dt, y_clip=y_clip)
    kw = dict(lam=lam, projection_horizon=ph, gn_iters=gn_iters,
              y_clip=y_clip, active_idx=union)
    if group is None:
        return insite_gn_finetune_predict(
            library, coefs.repeat_interleave(per_seed, dim=0), prev,
            statics, arms, lengths, dt, **kw)[0]

    def first(x):
        return x.reshape(-1, group, *x.shape[1:])[:, 0]

    _, coefs_pref = insite_gn_finetune_predict(
        library, coefs.repeat_interleave(per_seed // group, dim=0),
        first(prev), first(statics), first(arms), first(lengths), dt, **kw)
    return batched_rollout(library, coefs_pref.repeat_interleave(group,
                                                                 dim=0),
                           prev[:, 0], statics, arms, dt, y_clip=y_clip)


def _one_step_rmses(preds, rows, lengths, valid, S, norm_c):
    """Per seed (rmse_orig, rmse_all, rmse_last) [S], % of ``norm_c``:
    the masked RMSE over time steps, over all active entries and over each
    row's last active step, in float64."""
    target = rows[:, 1:].double().reshape(S, -1, rows.shape[1] - 1)
    preds = preds.double().reshape(target.shape)
    steps = torch.arange(target.shape[-1], device=rows.device)
    active = (steps < lengths.reshape(S, -1, 1)).double()
    if valid is not None:
        active = active * valid.double().reshape(S, -1, 1)
    err = torch.where(active > 0, preds - target, 0.0)
    se = err * err
    mse_orig = (se.sum(1) / torch.clamp(active.sum(1), min=1.0)).mean(-1)
    r_orig = torch.sqrt(mse_orig) / norm_c * 100.0
    r_all = torch.sqrt(se.sum((1, 2)) / active.sum((1, 2))) / norm_c * 100.0
    last = torch.clamp(active - torch.cat(
        [active[..., 1:], torch.zeros_like(active[..., :1])], dim=-1),
        min=0.0)
    r_last = torch.sqrt((se * last).sum((1, 2)) / torch.clamp(
        last.sum((1, 2)), min=1.0)) / norm_c * 100.0
    return r_orig, r_all, r_last


def _n_step_rmses(preds, rows, lengths, valid, S, ph, norm_c):
    """Per seed and horizon [S, ph], % of ``norm_c``: the RMSE over the
    rows (the valid ones) of the last ph predicted steps of each row."""
    win = (lengths - ph)[:, None] + torch.arange(ph, device=rows.device)
    err = (preds.gather(1, win).double() -
           rows[:, 1:].gather(1, win).double())
    if valid is None:
        valid = torch.ones(rows.shape[0], dtype=torch.float64,
                           device=rows.device)
    err = torch.where(valid[:, None] > 0, err, 0.0).reshape(S, -1, ph)
    denom = torch.clamp(valid.double().reshape(S, -1).sum(1), min=1.0)
    return torch.sqrt((err * err).sum(1) / denom[:, None]) / norm_c * 100.0


@span('fit')
def discover_column(cohorts, *, family: str, method: str, threshold: float,
                    alpha: float, dt: float = STANDARD_DT) -> np.ndarray:
    """Every seed's global model of a column, [S, A, F] float64 numpy:
    the family's design over the seeds' stacked training cohorts, then
    `_discover`."""
    eq4 = family == 'eq4'
    statics = cohorts[0]['train'][3]
    library = PolynomialLibrary(n_inputs=1 + statics.shape[-1])
    return _discover(cohorts, library, 2 if eq4 else 4, eq4, method,
                     threshold, alpha, dt)


@span('predict')
def evaluate_column(cohorts, coefs_np, *, family: str, method: str,
                    lam: float, projection_horizon: int, gn_iters: int = 12,
                    dedup_one_step: bool = False, dt: float = STANDARD_DT,
                    union=None) -> dict:
    """The 1-step and n-step evaluation of a column whose seeds' global
    models are ``coefs_np`` [S, A, F]: every seed's 1-step rows in one
    batch and every seed's n-step rows in another. INSITE fine-tunes in
    the coordinates ``union`` (the union of these seeds' supports when
    None; a block of a sharded column takes the whole column's). Returns
    the per-seed arrays of `column`."""
    eq4 = family == 'eq4'
    S, ph = len(cohorts), projection_horizon
    train_statics = cohorts[0]['train'][3]
    dtype, dev = train_statics.dtype, train_statics.device
    library = PolynomialLibrary(n_inputs=1 + train_statics.shape[-1])
    norm_c = MAX_VALUE if eq4 else TUMOUR_DEATH_THRESHOLD
    y_clip = None if eq4 else (0.0, float(TUMOUR_DEATH_THRESHOLD))
    coefs = to_device(coefs_np, dev, dtype)
    kw = dict(insite=(method == 'insite'), lam=lam, gn_iters=gn_iters,
              y_clip=y_clip,
              union=support(coefs_np) if union is None else union)

    rows, arms, lengths, statics, valid = _stack(cohorts, 'one_step')
    preds = _predict(library, coefs, rows, arms, lengths, statics, dt, ph=1,
                     group=2 if (eq4 and dedup_one_step) else None, **kw)
    r_orig, r_all, r_last = _one_step_rmses(preds, rows, lengths, valid, S,
                                            norm_c)
    rows, arms, lengths, statics, valid = _stack(cohorts, 'n_step')
    preds = _predict(library, coefs, rows, arms, lengths, statics, dt,
                     ph=ph, group=2 * ph, **kw)
    n_step = _n_step_rmses(preds, rows, lengths, valid, S, ph, norm_c)
    out = {'encoder_test_rmse_orig': r_orig, 'encoder_test_rmse_all': r_all,
           'encoder_test_rmse_last': r_last}
    out.update({f'decoder_test_rmse_{k + 2}-step': n_step[:, k]
                for k in range(ph)})
    out = {k: to_host(v).numpy() for k, v in out.items()}
    out['global_coefs'] = coefs_np
    return out


def column(cohorts, *, family: str, method: str, threshold: float,
           alpha: float, lam: float, projection_horizon: int,
           gn_iters: int = 12, dedup_one_step: bool = False,
           dt: float = STANDARD_DT) -> dict:
    """One seed column from its seeds' cohorts (`eq4_cohort`, or
    `tumor_cohort` of `tumor_draws`): discovery per seed
    (`discover_column`), then every seed's 1-step rows in one batch and
    every seed's n-step rows in another (`evaluate_column`).
    ``family`` is 'eq4' or 'tumor'. The n-step fine-tune runs once per
    (patient, prefix) on its first plan; ``dedup_one_step`` does the same
    for the 1-step rows' two branches (EQ_4). Returns per seed:
    'encoder_test_rmse_orig', '_all', '_last' [S],
    'decoder_test_rmse_{2..ph+1}-step' [S] and 'global_coefs' [S, A, F]
    (float64 numpy)."""
    coefs = discover_column(cohorts, family=family, method=method,
                            threshold=threshold, alpha=alpha, dt=dt)
    return evaluate_column(cohorts, coefs, family=family, method=method,
                           lam=lam, projection_horizon=projection_horizon,
                           gn_iters=gn_iters, dedup_one_step=dedup_one_step,
                           dt=dt)


def _summary(res: dict, n_seeds: int) -> dict:
    res['mean'] = float(np.mean(res['encoder_test_rmse_orig']))
    res['ci95'] = (float(ci(res['encoder_test_rmse_orig']))
                   if n_seeds > 1 else 0.0)
    return res


# ---------------------------------------------------------------------------
# sweeps

def vectorized_eq4_sweep(equation_str: str, n_seeds: int = 10,
                         n_train: int = 1000, n_test: int = 100,
                         seq_length: int = 60, conf_coeff: float = 2.0,
                         threshold: float = 0.1, alpha: float = 0.5,
                         lam: float = 10.0, method: str = 'insite',
                         gn_iters: int = 12, projection_horizon: int = 5,
                         noise_scale: float = 1.0,
                         dedup_one_step: bool = False, *, device=None,
                         dtype=None, mesh=None) -> dict:
    """Seeds 0..n_seeds-1 of one (EQ_4 dataset, method) column on
    ``device``: per-seed arrays (metrics [S], 'global_coefs' [S, 2, 7])
    and the 1-step 'mean' and 'ci95'. The 1-step rows are fine-tuned one
    by one unless ``dedup_one_step``.

    With a ``mesh`` (`parallel.batch_mesh`; ``device`` is then unused),
    the seeds are split into one block per device (n_seeds a multiple of
    the mesh size, as in the JAX package): each block's cohorts, design,
    discovery and fine-tune run as a column of their own on its device,
    and the per-seed results are joined in seed order. A seed's cohort
    comes from its own generator whatever its block, and a row moves only
    its own seed's support, so the mesh changes placement, not the
    results."""
    assert 'EQ_4' in equation_str
    assert method in ('insite', 'sindy', 'wsindy')
    if device is None and mesh is None:
        raise TypeError('vectorized_eq4_sweep needs device= or mesh=')
    blocks = ([(device, slice(0, n_seeds))] if mesh is None
              else seed_blocks(n_seeds, mesh))
    cohorts = [[eq4_cohort(s, equation_str, n_train, n_test, seq_length,
                           conf_coeff, projection_horizon, noise_scale,
                           device=dev, dtype=dtype)
                for s in range(seeds.start, seeds.stop)]
               for dev, seeds in blocks]
    coefs = [discover_column(c, family='eq4', method=method,
                             threshold=threshold, alpha=alpha)
             for c in cohorts]
    union = support(np.concatenate(coefs))
    parts = [evaluate_column(c, k, family='eq4', method=method, lam=lam,
                             projection_horizon=projection_horizon,
                             gn_iters=gn_iters,
                             dedup_one_step=dedup_one_step, union=union)
             for c, k in zip(cohorts, coefs)]
    res = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return _summary(res, n_seeds)


def vectorized_confounding_sweep(equation_str: str = 'EQ_4_D',
                                 gammas=(0.0, 1.0, 2.0, 3.0, 4.0),
                                 n_seeds: int = 10, n_train: int = 1000,
                                 n_test: int = 100, seq_length: int = 60,
                                 method: str = 'insite', threshold=0.1,
                                 alpha=0.5, lam=10.0, gn_iters: int = 12,
                                 projection_horizon: int = 5, *, device,
                                 dtype=None) -> dict:
    """INSIGHT_CONFOUNDING: one column of seeds per gamma. As in the JAX
    package, these columns fine-tune the 1-step rows once per prefix (on
    the factual branch). Returns {'gammas': [G], '<metric>': [G, S]}."""
    assert 'EQ_4' in equation_str and method in ('insite', 'sindy',
                                                 'wsindy')
    cols = [vectorized_eq4_sweep(
        equation_str, n_seeds=n_seeds, n_train=n_train, n_test=n_test,
        seq_length=seq_length, conf_coeff=float(g), threshold=threshold,
        alpha=alpha, lam=lam, method=method, gn_iters=gn_iters,
        projection_horizon=projection_horizon, dedup_one_step=True,
        device=device, dtype=dtype) for g in gammas]
    res = {'gammas': np.asarray(gammas)}
    for k, v in cols[0].items():
        if isinstance(v, np.ndarray) and v.ndim == 1:
            res[k] = np.stack([c[k] for c in cols])
    return res


def vectorized_tumor_sweep(dataset_name: str, n_seeds: int = 10,
                           n_train: int = 1000, n_test: int = 100,
                           seq_length: int = 60, coeff: float = 2.0,
                           threshold: float = 0.001, alpha: float = 0.5,
                           lam: float = 10.0, method: str = 'insite',
                           gn_iters: int = 12, projection_horizon: int = 5,
                           *, device, dtype=None) -> dict:
    """Seeds 0..n_seeds-1 of one (cancer_sim or EQ_5 dataset, method)
    column on ``device``. Library inputs are the standard path's: [volume,
    patient type], plus the identically zero t = 0 chemo dosage on EQ_5
    (its coefficients are exactly 0). Distribution-level cohort parity."""
    assert dataset_name in TUMOR_VARIANTS
    assert method in ('insite', 'sindy')
    cohorts = [tumor_cohort(
        tumor_draws(s, dataset_name, n_train, n_test, seq_length, coeff,
                    projection_horizon, device=device, dtype=dtype),
        seq_length, projection_horizon,
        include_dosage='EQ_5' in dataset_name) for s in range(n_seeds)]
    res = column(cohorts, family='tumor', method=method,
                 threshold=threshold, alpha=alpha, lam=lam,
                 projection_horizon=projection_horizon, gn_iters=gn_iters)
    return _summary(res, n_seeds)
