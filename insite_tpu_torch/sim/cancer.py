"""Cancer PKPD ("cancer_sim") benchmark simulator: parameter sampling and
the factual and counterfactual generators, built on the batched tumor core.

Every random number comes from the ``np.random.RandomState`` the caller
passes, in the order in which `insite_tpu.sim.cancer` takes its numbers
from the global ``np.random`` (the reference's order): the parameters, then
the trajectory draws (array at once for the factual cohort, interleaved per
patient for the counterfactual sets), then the observation noise of the
EQ_5 variants, then the random treatment plans. A ``RandomState`` seeded
like the global state therefore draws the JAX package's cohort.

The host draws the arrays, they go to ``device`` once, the cores run there,
and the results come back in one host copy.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import truncnorm

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.sim.tumor import (CHEMO_AMT, DRUG_DECAY, OPTIONS_CHEMO,
                                        PARAM_KEYS, TUMOUR_DEATH_THRESHOLD,
                                        calc_diameter, calc_volume,
                                        cf_factual_core, cf_one_step_rows,
                                        cf_seq_rows, factual_core)

TUMOUR_SIZE_DISTRIBUTIONS = {'I': (1.72, 4.70, 0.3, 5.0),
                             'II': (1.96, 1.63, 0.3, 13.0),
                             'IIIA': (1.91, 9.40, 0.3, 13.0),
                             'IIIB': (2.76, 6.87, 0.3, 13.0),
                             'IV': (3.86, 8.82, 0.3, 13.0)}
CANCER_STAGE_OBSERVATIONS = {'I': 1432, 'II': 128, 'IIIA': 1306,
                             'IIIB': 7248, 'IV': 12840}
CF_SEQ_MODES = ('sliding_treatment', 'random_trajectories')


def get_standard_params(num_patients: int, rs: np.random.RandomState,
                        patient_type_choices=(1, 2, 3),
                        beta_c_noise: bool = True) -> dict:
    """Patient parameters as numpy arrays. ``patient_type_choices`` and
    ``beta_c_noise`` set the EQ_5 heterogeneity variants."""
    total = sum(CANCER_STAGE_OBSERVATIONS.values())
    stages = sorted(TUMOUR_SIZE_DISTRIBUTIONS)
    probs = [CANCER_STAGE_OBSERVATIONS[s] / total for s in stages]
    initial_stages = rs.choice(stages, num_patients, p=probs)

    output_initial_diam, patient_sim_stages = [], []
    for stg in stages:
        count = int(np.sum(initial_stages == stg))
        mu, sigma, lo, hi = TUMOUR_SIZE_DISTRIBUTIONS[stg]
        lb = (np.log(lo) - mu) / sigma
        ub = (np.log(hi) - mu) / sigma
        norm_rvs = truncnorm.rvs(lb, ub, size=count, random_state=rs)
        output_initial_diam += list(np.exp(norm_rvs * sigma + mu))
        patient_sim_stages += [stg] * count

    K = calc_volume(30)
    alpha_beta_ratio = 10
    alpha_rho_corr = 0.87
    rho_params = (7e-5, 7.23e-3)
    alpha_params = (0.0398, 0.168)
    beta_c_params = (0.028, 0.0007)
    cov = np.array([[alpha_params[1] ** 2,
                     alpha_rho_corr * alpha_params[1] * rho_params[1]],
                    [alpha_rho_corr * alpha_params[1] * rho_params[1],
                     rho_params[1] ** 2]])
    mean = np.array([alpha_params[0], rho_params[0]])

    # rejection of non-positive (alpha, rho) pairs, whole batches at a time
    simulated = []
    while len(simulated) < num_patients:
        holder = rs.multivariate_normal(mean, cov, size=num_patients)
        simulated += [row for row in holder if row[0] > 0.0 and row[1] > 0.0]

    patient_types = rs.choice(list(patient_type_choices), num_patients)
    chemo_adj = np.where(patient_types < 3, 0.0, 0.1)
    radio_adj = np.where(patient_types > 1, 0.0, 0.1)

    simulated = np.array(simulated)[:num_patients]
    alpha = simulated[:, 0] + alpha_params[0] * radio_adj
    rho = simulated[:, 1]
    beta = alpha / alpha_beta_ratio

    beta_c_adj = beta_c_params[0] * chemo_adj
    if beta_c_noise:
        beta_c = beta_c_params[0] + beta_c_params[1] * truncnorm.rvs(
            (0.0 - beta_c_params[0]) / beta_c_params[1], np.inf,
            size=num_patients, random_state=rs) + beta_c_adj
    else:
        beta_c = beta_c_params[0] + beta_c_adj

    holder = {'patient_types': patient_types,
              'initial_stages': np.array(patient_sim_stages),
              'initial_volumes': calc_volume(np.array(output_initial_diam)),
              'alpha': alpha, 'rho': rho, 'beta': beta, 'beta_c': beta_c,
              'K': np.full(num_patients, K)}
    idx = list(range(num_patients))
    rs.shuffle(idx)
    return {k: v[idx] for k, v in holder.items()}


def generate_params(num_patients: int, chemo_coeff: float,
                    radio_coeff: float, window_size: int, lag: int,
                    rs: np.random.RandomState, patient_type_choices=(1, 2, 3),
                    beta_c_noise: bool = True) -> dict:
    """The numpy parameter dict of a cohort: patient parameters, the
    sigmoid confounding constants, window and lag."""
    params = get_standard_params(num_patients, rs, patient_type_choices,
                                 beta_c_noise)
    d_max = calc_diameter(TUMOUR_DEATH_THRESHOLD)
    n = num_patients
    params['chemo_sigmoid_intercepts'] = np.full(n, d_max / 2.0)
    params['radio_sigmoid_intercepts'] = np.full(n, d_max / 2.0)
    params['chemo_sigmoid_betas'] = np.full(n, chemo_coeff / d_max)
    params['radio_sigmoid_betas'] = np.full(n, radio_coeff / d_max)
    params['window_size'] = window_size
    params['lag'] = lag
    return params


def device_params(params: dict, device, dtype) -> dict:
    """The cores' parameter tensors (`PARAM_KEYS`) on ``device``."""
    return {k: torch.as_tensor(params[k], dtype=dtype, device=device)
            for k in PARAM_KEYS}


def factual_rvs(rs: np.random.RandomState, num_patients: int,
                seq_length: int) -> dict:
    """Array-at-once draw order of the factual generator."""
    shape = (num_patients, seq_length)
    return {'noise': 0.01 * rs.randn(*shape), 'recovery': rs.rand(*shape),
            'chemo_rv': rs.rand(*shape), 'radio_rv': rs.rand(*shape)}


def cf_rvs(rs: np.random.RandomState, num_patients: int, seq_length: int,
           noise_len: int) -> dict:
    """Per-patient interleaved draw order of the counterfactual
    generators."""
    noise = np.empty((num_patients, noise_len))
    recovery = np.empty((num_patients, seq_length))
    chemo = np.empty((num_patients, seq_length))
    radio = np.empty((num_patients, seq_length))
    for i in range(num_patients):
        noise[i] = 0.01 * rs.randn(noise_len)
        recovery[i] = rs.rand(seq_length)
        chemo[i] = rs.rand(seq_length)
        radio[i] = rs.rand(seq_length)
    return {'noise': noise, 'recovery': recovery, 'chemo_rv': chemo,
            'radio_rv': radio}


def _to_device(arrays: dict, device, dtype) -> dict:
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in arrays.items()}


def _finish(out: dict, rs, extra_noise: bool) -> dict:
    """The EQ_5 B/C/D observation noise on every emitted volume, and the
    reference's NaN guard."""
    if extra_noise:
        out['cancer_volume'] = out['cancer_volume'] + \
            0.01 * rs.normal(size=out['cancer_volume'].shape)
    assert not np.any(np.isnan(out['cancer_volume']))
    return out


def simulate_factual(params: dict, seq_length: int,
                     rs: np.random.RandomState, *, device, dtype=None,
                     extra_noise: bool = False) -> dict:
    """The factual cohort as numpy: the trajectory arrays [B, T], the
    sequence lengths and the patient types."""
    dtype = resolve_float(dtype)
    n = len(params['initial_volumes'])
    rvs = _to_device(factual_rvs(rs, n, seq_length), device, dtype)
    out = factual_core(device_params(params, device, dtype), rvs, seq_length,
                       int(params['window_size']), int(params['lag']))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out['patient_types'] = np.asarray(params['patient_types'])
    return _finish(out, rs, extra_noise)


def _valid_rows(rows: dict, seq_lengths, valid) -> tuple:
    """The valid rows of each [B, R..., W] block as [N, W], and the
    sequence lengths [N], copied to the host once; and the host mask."""
    keep = valid.reshape(-1)
    out = {k: v.reshape(-1, v.shape[-1])[keep] for k, v in rows.items()}
    out['sequence_lengths'] = seq_lengths.reshape(-1)[keep]
    return {k: v.cpu().numpy() for k, v in out.items()}, keep.cpu().numpy()


def simulate_counterfactual_1_step(params: dict, seq_length: int,
                                   rs: np.random.RandomState, *, device,
                                   dtype=None, extra_noise: bool = False,
                                   emit_dosage: bool = False) -> dict:
    """The one-step test set as numpy: up to 4 (T-1) rows per patient, T
    wide; with ``emit_dosage`` also the chemo dosage rows, whose last entry
    is the counterfactual option's dosage."""
    dtype = resolve_float(dtype)
    n = len(params['initial_volumes'])
    T = seq_length
    p = device_params(params, device, dtype)
    rvs = _to_device(cf_rvs(rs, n, T, T), device, dtype)
    fact = cf_factual_core(p, rvs, T, int(params['window_size']),
                           int(params['lag']))
    vol_rows, chemo_rows, radio_rows, seq_lengths, valid = cf_one_step_rows(
        p, fact, rvs['noise'], T)
    rows = {'cancer_volume': vol_rows, 'chemo_application': chemo_rows,
            'radio_application': radio_rows}
    if emit_dosage:
        dose = fact['chemo_dosage']                              # [B, T-1]
        prev = torch.cat([dose.new_zeros(n, 1), dose[:, :-1]], dim=1)
        opt_c = torch.tensor(OPTIONS_CHEMO, dtype=dtype, device=dose.device)
        t_grid = torch.arange(T - 1, device=dose.device)[:, None]
        j_grid = torch.arange(T, device=dose.device)[None, :]
        dose_rows = torch.where(
            (j_grid < t_grid)[None, :, None, :],
            torch.cat([dose, dose.new_zeros(n, 1)], dim=1)[:, None, None, :],
            0.0)
        cf_dose = prev[:, :, None] * DRUG_DECAY + CHEMO_AMT * opt_c
        rows['chemo_dosage'] = torch.where(
            (j_grid == t_grid)[None, :, None, :], cf_dose[..., None],
            dose_rows)
    out, keep = _valid_rows(rows, seq_lengths, valid)
    out['patient_types'] = np.repeat(np.asarray(params['patient_types']),
                                     (T - 1) * 4)[keep]
    return _finish(out, rs, extra_noise)


def treatment_plans(rs: np.random.RandomState, num_patients: int,
                    seq_length: int, ph: int, cf_seq_mode: str) -> np.ndarray:
    """The 2 ph (chemo, radio) plans of every (patient, prefix):
    [B, T-1, 2ph, ph, 2]. ``sliding_treatment``: chemo alone at each offset,
    then radio alone at each offset; ``random_trajectories``: fair 0/1
    draws."""
    shape = (num_patients, seq_length - 1, 2 * ph, ph, 2)
    if cf_seq_mode == 'sliding_treatment':
        eye = np.eye(ph, dtype=np.int64)
        zero = np.zeros((ph, ph), dtype=np.int64)
        plans = np.concatenate([np.stack([eye, zero], axis=-1),
                                np.stack([zero, eye], axis=-1)])
        return np.broadcast_to(plans, shape)
    if cf_seq_mode == 'random_trajectories':
        return rs.randint(0, 2, shape)
    raise ValueError(f'cf_seq_mode must be one of {CF_SEQ_MODES}, got '
                     f'{cf_seq_mode!r}')


def simulate_counterfactuals_treatment_seq(
        params: dict, seq_length: int, projection_horizon: int,
        rs: np.random.RandomState, *, device,
        cf_seq_mode: str = 'sliding_treatment', dtype=None,
        extra_noise: bool = False, emit_dosage: bool = False) -> dict:
    """The n-step test set as numpy: up to 2 ph (T-1) rows per patient,
    T+ph wide, with each row's patient id and prefix end."""
    dtype = resolve_float(dtype)
    ph = projection_horizon
    n = len(params['initial_volumes'])
    T = seq_length
    p = device_params(params, device, dtype)
    rvs = _to_device(cf_rvs(rs, n, T, T + ph), device, dtype)
    fact = cf_factual_core(p, rvs, T, int(params['window_size']),
                           int(params['lag']))
    plans = treatment_plans(rs, n, T, ph, cf_seq_mode)
    (vol_rows, chemo_rows, radio_rows, dose_rows, seq_lengths,
     valid) = cf_seq_rows(p, fact,
                          torch.as_tensor(np.ascontiguousarray(plans),
                                          device=device),
                          rvs['noise'], T, ph)
    rows = {'cancer_volume': vol_rows, 'chemo_application': chemo_rows,
            'radio_application': radio_rows}
    if emit_dosage:
        rows['chemo_dosage'] = dose_rows
    out, keep = _valid_rows(rows, seq_lengths, valid)
    rows_pp = (T - 1) * 2 * ph
    patient_ids = np.repeat(np.arange(n), rows_pp)[keep]
    current_t = np.tile(np.repeat(np.arange(T - 1), 2 * ph), n)[keep]
    out['patient_types'] = np.asarray(params['patient_types'])[patient_ids]
    out['patient_ids_all_trajectories'] = patient_ids.astype(np.float64)
    out['patient_current_t'] = current_t.astype(np.float64)
    return _finish(out, rs, extra_noise)


def get_scaling_params(sim: dict):
    """Mean and std over the active entries of the volume and dosages, and
    of the patient types, as dicts of floats."""
    lengths = np.asarray(sim['sequence_lengths']).astype(np.int64)
    means, stds = {}, {}
    for k in ('cancer_volume', 'chemo_dosage', 'radio_dosage'):
        if k not in sim:
            continue
        arr = np.asarray(sim[k])
        mask = np.arange(arr.shape[1])[None, :] < lengths[:, None]
        active = arr[mask]
        means[k] = float(active.mean())
        stds[k] = float(active.std())
    means['patient_types'] = float(np.mean(sim['patient_types']))
    stds['patient_types'] = float(np.std(sim['patient_types']))
    return means, stds
