"""PKPD "EQ_4" simulator, factual path: one-compartment exponential-decay
pharmacology with a time-constant, confounded treatment arm per patient.

The ground truth is ``dy/dt = -C_a * y`` with the decay constant switched
by the arm. The Euler discretisation of a linear homogeneous ODE is a fixed
per-interval factor, so the whole factual cohort is one cumulative product
over ``[B, T]``.

As in `insite_tpu.sim.pkpd`, the core (`_simulate_factual_core`) takes its
random draws as arguments, so parity tests feed both packages the same
draws; `_simulate_factual_full` draws them from a ``torch.Generator``. The
draws are not jax's threefry bits: the two packages agree in distribution,
not in samples.
"""

from __future__ import annotations

from enum import IntEnum

import torch

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

    c_0 = torch.randn(num_patients, **kw) * sigma_0 + c_0_mean
    c_1 = torch.randn(num_patients, **kw) * sigma_1 + c_1_mean

    C_0, C_1 = c_0, c_1
    name = equation.name
    if name in ('EQ_4_C', 'EQ_4_D'):
        # fixed linear dependence on the observed statics
        C_0 = 1.0 * c_0 + 0.1 * scale
        C_1 = 1.0 * c_1 + 0.3 * scale
        if name == 'EQ_4_D':
            # one shift per arm, shared by the whole cohort
            sigma_c = 0.5 * scale
            C_0 = torch.randn((), **kw) * sigma_c + C_0
            C_1 = torch.randn((), **kw) * sigma_c + C_1
    elif name == 'EQ_4_M':
        modes = torch.tensor([0.1, 0.3], dtype=dtype, device=device) * scale
        C_0 = c_0 + modes[torch.randint(0, 2, (num_patients,),
                                        generator=generator, device=device)]
        C_1 = c_1 + modes[torch.randint(0, 2, (num_patients,),
                                        generator=generator, device=device)]
    elif 'EQ_5' in name:
        raise NotImplementedError('EQ_5 is not ported yet')

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
