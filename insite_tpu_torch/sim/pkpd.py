"""PKPD "EQ_4" simulator: one-compartment exponential-decay pharmacology
with a time-constant, confounded treatment arm per patient, its factual
cohorts and both counterfactual test sets.

The ground truth is ``dy/dt = -C_a * y`` with the decay constant switched
by the arm. The Euler discretisation of a linear homogeneous ODE is a fixed
per-interval factor, so the whole factual cohort is one cumulative product
over ``[B, T]``, and every counterfactual row is a select or a cumulative
product over the factual trajectory and the two per-arm factors.

As in `insite_tpu.sim.pkpd`, each core (`_simulate_factual_core`,
`_simulate_cf_1_step_core`, `_simulate_cf_seq_core`) takes its random
draws as arguments, so parity tests feed both packages the same draws; the
``_full`` functions draw them from a ``torch.Generator``. The draws are not
jax's threefry bits: the two packages agree in distribution, not in
samples.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch
import torch.nn.functional as nnf

from insite_tpu_torch.core.constants import (
    HMAX,
    MAX_TIME_HORIZON,
    MAX_VALUE,
    OBSERVATION_NOISE,
    RECOVERY_MULTIPLIER,
    STEPS_FOR_DT,
)
from insite_tpu_torch.core.dtypes import resolve_float


class Equation(IntEnum):
    EQ_4_A = 1
    EQ_4_B = 2
    EQ_4_C = 3
    EQ_4_D = 4
    EQ_5_A = 5
    EQ_5_B = 6
    EQ_5_C = 7
    EQ_5_D = 8
    EQ_4_M = 9


class CfSeqMode(IntEnum):
    SLIDING_TREATMENT = 1
    RANDOM_TRAJECTORIES = 2


def true_dy_dt(y, t, treatment, hidden_c0, hidden_c1):
    """The ground-truth vector field ``-c * y``, ``c`` the decay constant
    of the treatment arm (``hidden_c0`` for arm 0, ``hidden_c1``
    otherwise); every argument broadcasts, ``t`` is unused."""
    c = torch.where(torch.as_tensor(treatment) == 0, hidden_c0, hidden_c1)
    return -c * y


def _substeps_for(seq_length: int) -> int:
    """The reference integrates with STEPS_FOR_DT sub-steps only when
    dt > HMAX; for seq_length >= 300 one Euler step is used."""
    dt = MAX_TIME_HORIZON / seq_length
    return STEPS_FOR_DT if dt > HMAX else 1


def _decay_factor(c, dt, substeps: int = STEPS_FOR_DT):
    """The exact multiplier that ``substeps`` Euler sub-steps of
    ``dy/dt = -c*y`` apply over one interval (same operation order as the
    JAX package, so float64 results agree bit for bit)."""
    h = dt / substeps
    y = torch.ones_like(c)
    for _ in range(substeps):
        y = y + (-c * y) * h
    return y


# ---------------------------------------------------------------------------
# Parameter generation

def generate_params(num_patients: int, conf_coeff: float, window_size: int,
                    lag: int, generator: torch.Generator, equation: Equation,
                    device, dtype=None) -> dict:
    params = get_standard_params(num_patients, equation, generator, device,
                                 dtype=dtype)
    params['observation_noise'] = OBSERVATION_NOISE
    params['sigmoid_intercept'] = MAX_VALUE / 2.0
    params['sigmoid_gamma'] = conf_coeff / MAX_VALUE
    params['window_size'] = window_size
    params['lag'] = lag
    return params


def get_standard_params(num_patients: int, equation: Equation,
                        generator: torch.Generator, device,
                        dtype=None) -> dict:
    """Patient-specific constants for variants A (clean), B (+obs noise),
    C (params linear in observed statics), D (C + a shared per-arm shift),
    M (multimodal). Same distributions as the JAX package."""
    dtype = resolve_float(dtype)
    kw = dict(generator=generator, device=device, dtype=dtype)
    scale = 0.5
    sigma_0 = 0.1 * scale
    sigma_1 = 0.1 * scale
    c_0_mean = 1.0 * scale
    c_1_mean = 1.0 * scale
    name = equation.name
    if name == 'EQ_4_D':
        # one shift per arm, shared by the whole population: drawn before
        # any per-patient draw, so that cohorts of any size seeded alike
        # (a collection's train, val and test subsets) share it, as the
        # JAX package's size-independent key splits make them
        sigma_c = 0.5 * scale
        shift_0 = torch.randn((), **kw) * sigma_c
        shift_1 = torch.randn((), **kw) * sigma_c

    c_0 = torch.randn(num_patients, **kw) * sigma_0 + c_0_mean
    c_1 = torch.randn(num_patients, **kw) * sigma_1 + c_1_mean

    C_0, C_1 = c_0, c_1
    if name in ('EQ_4_C', 'EQ_4_D'):
        # fixed linear dependence on the observed statics
        C_0 = 1.0 * c_0 + 0.1 * scale
        C_1 = 1.0 * c_1 + 0.3 * scale
        if name == 'EQ_4_D':
            C_0 = shift_0 + C_0
            C_1 = shift_1 + C_1
    elif name == 'EQ_4_M':
        modes = torch.tensor([0.1, 0.3], dtype=dtype, device=device) * scale
        C_0 = c_0 + modes[torch.randint(0, 2, (num_patients,),
                                        generator=generator, device=device)]
        C_1 = c_1 + modes[torch.randint(0, 2, (num_patients,),
                                        generator=generator, device=device)]
    elif 'EQ_5' in name:
        raise NotImplementedError(
            'EQ_5 lives in insite_tpu_torch.sim.continuous')

    initial_volumes = torch.rand(num_patients, **kw) * (MAX_VALUE - 1.0) + 1.0

    holder = {
        'initial_volumes': initial_volumes,
        'hidden_C_0': C_0,
        'hidden_C_1': C_1,
        'observed_static_c_0': c_0,
        'observed_static_c_1': c_1,
    }
    idx = torch.randperm(num_patients, generator=generator, device=device)
    params = {k: v[idx] for k, v in holder.items()}
    params['observation_noise'] = OBSERVATION_NOISE
    return params


# ---------------------------------------------------------------------------
# Shared pieces

def _treatment_from_rv(params, rv):
    """Confounded biased coin per patient: p = sigma(gamma*(y0 - MAX/2))."""
    y0 = params['initial_volumes']
    prob = 1.0 / (1.0 + torch.exp(-params['sigmoid_gamma'] *
                                  (y0 - params['sigmoid_intercept'])))
    return (rv < prob).to(torch.int32)


def _factual_volumes(params, treatment, n_steps, dtype, dt,
                     substeps: int = STEPS_FOR_DT):
    """Closed-form batched factual rollout: ``[B, n_steps+1]`` volumes."""
    v0 = params['initial_volumes'].to(dtype)
    dt = torch.as_tensor(dt, dtype=dtype, device=v0.device)
    c = torch.where(treatment == 1, params['hidden_C_1'],
                    params['hidden_C_0'])
    f = _decay_factor(c.to(dtype), dt, substeps)                   # [B]
    cum = torch.cumprod(f[:, None].expand(f.shape[0], n_steps), dim=1)
    return torch.cat([v0[:, None], v0[:, None] * cum], dim=1)


def _add_observation_noise_always(volumes, params, generator):
    return volumes + params['observation_noise'] * torch.randn(
        volumes.shape, generator=generator, dtype=volumes.dtype,
        device=volumes.device)


# ---------------------------------------------------------------------------
# Factual simulation

def _simulate_factual_full(params, generator: torch.Generator,
                           seq_length: int, add_noise: bool, dtype=None):
    """Draw the recovery and treatment uniforms, run the core, and add the
    observation noise for variants B/C/D."""
    dtype = resolve_float(dtype)
    v0 = params['initial_volumes']
    kw = dict(generator=generator, dtype=dtype, device=v0.device)
    recovery_rvs = torch.rand((v0.shape[0], seq_length), **kw)
    treatment_rvs = torch.rand(v0.shape[0], **kw)
    volumes, treatments, seq_lengths = _simulate_factual_core(
        params, treatment_rvs, recovery_rvs, seq_length, dtype=dtype)
    if add_noise:
        volumes = _add_observation_noise_always(volumes, params, generator)
    return volumes, treatments, seq_lengths


def _first_true(cond):
    """(any, index of the first True) per row; argmax over int8 returns the
    first maximum, as jnp.argmax over a boolean does."""
    return cond.any(dim=1), torch.argmax(cond.to(torch.int8), dim=1)


def _simulate_factual_core(params, treatment_rvs, recovery_rvs,
                           seq_length: int, dtype=torch.float64):
    treatment = _treatment_from_rv(params, treatment_rvs)            # [B]
    volumes = _factual_volumes(params, treatment, seq_length - 1, dtype,
                               MAX_TIME_HORIZON / seq_length,
                               _substeps_for(seq_length))

    B, T = volumes.shape
    idx = torch.arange(T, device=volumes.device)

    # Recovery truncation: zero from the first step whose recovery draw
    # fires.
    recovery_cond = recovery_rvs < torch.exp(-volumes * RECOVERY_MULTIPLIER)
    any_rec, rec_idx = _first_true(recovery_cond)
    seq_lengths = torch.where(any_rec, rec_idx + 1, seq_length - 1)
    volumes = torch.where(
        any_rec[:, None] & (idx[None, :] >= rec_idx[:, None]), 0.0, volumes)

    # Death truncation: clamp to MAX_VALUE from the first exceedance,
    # applied after recovery and taking that branch's sequence length.
    any_death, death_idx = _first_true(volumes > MAX_VALUE)
    seq_lengths = torch.where(any_death, death_idx + 1, seq_lengths)
    volumes = torch.where(
        any_death[:, None] & (idx[None, :] >= death_idx[:, None]),
        MAX_VALUE, volumes)

    treatments = torch.cat(
        [treatment[:, None].expand(B, seq_length - 1),
         torch.zeros((B, 1), dtype=treatment.dtype, device=volumes.device)],
        dim=1).to(dtype)
    return volumes, treatments, seq_lengths


def _add_noise(equation: Equation) -> bool:
    return equation.name.split('_')[-1] in ('B', 'C', 'D')


def _to_numpy(**arrays) -> dict:
    """One host copy per array, and the reference's NaN guard."""
    out = {k: v.cpu().numpy() for k, v in arrays.items()}
    assert not np.any(np.isnan(out['cancer_volume']))
    return out


def simulate_factual(params, seq_length: int, generator: torch.Generator,
                     equation: Equation, dtype=None) -> dict:
    """The factual cohort as numpy: cancer_volume [B, T],
    treatment_application [B, T], sequence_lengths [B] and both statics."""
    volumes, treatments, seq_lengths = _simulate_factual_full(
        params, generator, seq_length, _add_noise(equation), dtype=dtype)
    return _to_numpy(cancer_volume=volumes, treatment_application=treatments,
                     sequence_lengths=seq_lengths,
                     observed_static_c_0=params['observed_static_c_0'],
                     observed_static_c_1=params['observed_static_c_1'])


def _counterfactual_rows(volumes, actions, seq_lengths, params) -> dict:
    """Flatten per-patient row blocks [B, R, W] to [B*R, W] and repeat each
    patient's statics over its R rows."""
    rows_pp = volumes.shape[1]
    return _to_numpy(
        cancer_volume=volumes.reshape(-1, volumes.shape[-1]),
        treatment_application=actions.reshape(-1, actions.shape[-1]),
        sequence_lengths=seq_lengths.reshape(-1),
        observed_static_c_0=params['observed_static_c_0'].repeat_interleave(
            rows_pp),
        observed_static_c_1=params['observed_static_c_1'].repeat_interleave(
            rows_pp))


# ---------------------------------------------------------------------------
# One-step counterfactuals

def _simulate_cf_1_step_full(params, generator: torch.Generator,
                             seq_length: int, add_noise: bool, dtype=None):
    dtype = resolve_float(dtype)
    v0 = params['initial_volumes']
    treatment_rvs = torch.rand(v0.shape[0], generator=generator, dtype=dtype,
                               device=v0.device)
    volumes, actions, seq_lengths = _simulate_cf_1_step_core(
        params, treatment_rvs, seq_length, dtype=dtype)
    if add_noise:
        volumes = _add_observation_noise_always(volumes, params, generator)
    return volumes, actions, seq_lengths


def simulate_counterfactual_1_step(params, seq_length: int,
                                   generator: torch.Generator,
                                   equation: Equation, dtype=None) -> dict:
    """The one-step test set as numpy: 2 (T-1) rows per patient."""
    out = _simulate_cf_1_step_full(params, generator, seq_length,
                                   _add_noise(equation), dtype=dtype)
    return _counterfactual_rows(*out, params)


def _simulate_cf_1_step_core(params, treatment_rvs, seq_length: int,
                             dtype=torch.float64):
    """All (patient, prefix end t, {factual, flipped arm}) rows at once.

    For every prefix end t (0..T-2) there is a factual row holding
    ``volumes[:t+2]`` and a counterfactual row whose last entry restarts
    from ``volumes[t]`` under the flipped arm: one select over
    ``[B, T-1, T]`` for each, interleaved. Returns (rows [B, 2(T-1), T],
    actions [B, 2(T-1), T], lengths [B, 2(T-1)])."""
    treatment = _treatment_from_rv(params, treatment_rvs)          # [B]
    dev = treatment.device
    dt = torch.as_tensor(MAX_TIME_HORIZON / seq_length, dtype=dtype,
                         device=dev)
    substeps = _substeps_for(seq_length)
    volumes = _factual_volumes(params, treatment, seq_length - 1, dtype, dt,
                               substeps)
    B, T = volumes.shape

    c_cf = torch.where(treatment == 0, params['hidden_C_1'],
                       params['hidden_C_0']).to(dtype)
    f_cf = _decay_factor(c_cf, dt, substeps)                       # [B]
    cf_next = volumes[:, :-1] * f_cf[:, None]                      # [B, T-1]

    TT = torch.arange(T - 1, device=dev)[:, None]                  # prefix end
    J = torch.arange(T, device=dev)[None, :]                       # [T-1, T]

    fact_rows = torch.where((J <= TT + 1)[None], volumes[:, None, :], 0.0)
    cf_rows = torch.where((J <= TT)[None], volumes[:, None, :], 0.0)
    cf_rows = torch.where((J == TT + 1)[None], cf_next[:, :, None], cf_rows)

    treat_b = treatment.to(dtype)[:, None, None]
    fact_actions = torch.where((J <= TT)[None], treat_b, 0.0)
    cf_actions = torch.where((J < TT)[None], treat_b, 0.0)
    cf_actions = torch.where((J == TT)[None], 1.0 - treat_b, cf_actions)

    rows = torch.stack([fact_rows, cf_rows], dim=2).reshape(B, 2 * (T - 1), T)
    actions = torch.stack([fact_actions, cf_actions], dim=2).reshape(
        B, 2 * (T - 1), T)
    seq_lengths = torch.arange(1, T, device=dev).repeat_interleave(2)
    return rows, actions, seq_lengths[None].expand(B, 2 * (T - 1))


# ---------------------------------------------------------------------------
# Treatment-sequence counterfactuals

CF_SEQ_MODES = ('sliding_treatment', 'random_trajectories')


def treatment_plans(num_patients: int, seq_length: int, ph: int,
                    cf_seq_mode: str, generator: torch.Generator, device):
    """The 2*ph treatment plans of every (patient, prefix end):
    int32 [B, T-1, 2ph, ph]. ``sliding_treatment``: one treated step at each
    offset, then its complement; ``random_trajectories``: fair 0/1 draws."""
    shape = (num_patients, seq_length - 1, 2 * ph, ph)
    if cf_seq_mode == 'sliding_treatment':
        eye = torch.eye(ph, dtype=torch.int32, device=device)
        return torch.cat([eye, 1 - eye], dim=0).expand(shape)
    if cf_seq_mode == 'random_trajectories':
        return torch.randint(0, 2, shape, generator=generator,
                             dtype=torch.int32, device=device)
    raise ValueError(f'cf_seq_mode must be one of {CF_SEQ_MODES}, got '
                     f'{cf_seq_mode!r}')


def _simulate_cf_seq_full(params, generator: torch.Generator,
                          seq_length: int, ph: int, cf_seq_mode: str,
                          add_noise: bool, dtype=None):
    dtype = resolve_float(dtype)
    v0 = params['initial_volumes']
    treatment_rvs = torch.rand(v0.shape[0], generator=generator, dtype=dtype,
                               device=v0.device)
    plans = treatment_plans(v0.shape[0], seq_length, ph, cf_seq_mode,
                            generator, v0.device)
    volumes, actions, seq_lengths = _simulate_cf_seq_core(
        params, treatment_rvs, plans, seq_length, ph, dtype=dtype)
    if add_noise:
        volumes = _add_observation_noise_always(volumes, params, generator)
    return volumes, actions, seq_lengths


def simulate_counterfactuals_treatment_seq(params, seq_length: int,
                                           projection_horizon: int,
                                           generator: torch.Generator,
                                           equation: Equation,
                                           cf_seq_mode='sliding_treatment',
                                           dtype=None) -> dict:
    """The n-step test set as numpy: 2 ph (T-1) rows per patient, each
    T+ph wide."""
    out = _simulate_cf_seq_full(params, generator, seq_length,
                                projection_horizon, cf_seq_mode,
                                _add_noise(equation), dtype=dtype)
    return _counterfactual_rows(*out, params)


def _simulate_cf_seq_core(params, treatment_rvs, plans, seq_length: int,
                          ph: int, dtype=torch.float64):
    """Every (patient, prefix end i, plan p) row at once.

    A plan's trajectory is the launch state ``volumes[i+1]`` times the
    running product of the per-arm decay factors the plan selects, so the
    whole ``[B, T-1, 2ph, ph]`` counterfactual block is one cumprod. Row
    (i, p) holds ``volumes[:i+2]`` then the plan's ph states, zero-padded to
    T+ph; its actions are the factual arm up to i, the plan over
    [i+1, i+ph], zero after. The ``[B, T-1, 2ph, T+ph]`` tensors are built
    on the device. Returns (rows [B, R, T+ph], actions [B, R, T+ph],
    lengths [B, R]) with R = (T-1) 2ph."""
    B = treatment_rvs.shape[0]
    treatment = _treatment_from_rv(params, treatment_rvs)
    dev = treatment.device
    dt = torch.as_tensor(MAX_TIME_HORIZON / seq_length, dtype=dtype,
                         device=dev)
    substeps = _substeps_for(seq_length)
    # the factual grid has seq_length + 1 points here
    volumes = _factual_volumes(params, treatment, seq_length, dtype, dt,
                               substeps)

    f_arm = torch.stack([
        _decay_factor(params['hidden_C_0'].to(dtype), dt, substeps),
        _decay_factor(params['hidden_C_1'].to(dtype), dt, substeps)], dim=1)

    plan_idx = plans.to(torch.int64)                    # [B, T-1, 2ph, ph]
    plan_f = torch.where(plan_idx == 1, f_arm[:, 1, None, None, None],
                         f_arm[:, 0, None, None, None])
    plan_cum = torch.cumprod(plan_f, dim=-1)
    launch = volumes[:, 1:seq_length]                   # [B, T-1] v[i+1]
    cf_vols = launch[:, :, None, None] * plan_cum       # [B, T-1, 2ph, ph]

    T_out = seq_length + ph
    n_pref = seq_length - 1
    t_grid = torch.arange(n_pref, device=dev)[:, None]
    j_grid = torch.arange(T_out, device=dev)[None, :]
    full = (B, n_pref, 2 * ph, T_out)

    pad_vol = nnf.pad(volumes, (0, T_out - volumes.shape[1]))
    base = torch.where((j_grid <= t_grid + 1)[None, :, None, :],
                       pad_vol[:, None, None, :], 0.0)  # [B, T-1, 1, T_out]
    k = j_grid - (t_grid + 2)                           # cf entry index
    cf_part = torch.gather(
        cf_vols, -1, torch.clamp(k, 0, ph - 1)[None, :, None, :].expand(full))
    in_cf = ((k >= 0) & (k < ph))[None, :, None, :]
    rows = torch.where(in_cf, cf_part, base)

    ka = j_grid - (t_grid + 1)                          # plan step index
    plan_part = torch.gather(
        plan_idx, -1,
        torch.clamp(ka, 0, ph - 1)[None, :, None, :].expand(full))
    in_plan = ((ka >= 0) & (ka < ph))[None, :, None, :]
    fact_part = torch.where((j_grid <= t_grid)[None, :, None, :],
                            treatment.to(torch.int64)[:, None, None, None],
                            0)
    actions = torch.where(in_plan, plan_part, fact_part).to(dtype)

    n_rows = n_pref * 2 * ph
    seq_lengths = (torch.arange(n_pref, device=dev) + 1 + ph
                   ).repeat_interleave(2 * ph)
    return (rows.reshape(B, n_rows, T_out), actions.reshape(B, n_rows, T_out),
            seq_lengths[None].expand(B, n_rows))


# ---------------------------------------------------------------------------
# Scaling

def get_scaling_params(sim: dict):
    """Mean/std of the active cancer-volume entries and of the statics, as
    plain dicts of floats (numpy in, numpy f64 arithmetic)."""
    vol = np.asarray(sim['cancer_volume'])
    lengths = np.asarray(sim['sequence_lengths']).astype(np.int64)
    mask = np.arange(vol.shape[1])[None, :] < lengths[:, None]
    active = vol[mask]
    means = {'cancer_volume': float(active.mean()),
             'observed_static_c_0': float(np.mean(sim['observed_static_c_0'])),
             'observed_static_c_1': float(np.mean(sim['observed_static_c_1']))}
    stds = {'cancer_volume': float(active.std()),
            'observed_static_c_0': float(np.std(sim['observed_static_c_0'])),
            'observed_static_c_1': float(np.std(sim['observed_static_c_1']))}
    return means, stds
