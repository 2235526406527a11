""""Continuous" EQ_5 A-D benchmark family: the tumor model re-parameterised
into four heterogeneity variants.

Differences from cancer_sim:
- A/B: a single patient type (no heterogeneity); C/D: three types
- D alone keeps the truncated-normal beta_c noise
- B/C/D add observation noise to every emitted cancer volume
- the counterfactual sets also carry the chemo dosage rows, so the SINDy
  family can take the dosage as a continuous covariate
"""

from __future__ import annotations

import numpy as np

from insite_tpu_torch.sim import cancer
from insite_tpu_torch.sim.pkpd import Equation


def _variant(equation: Equation):
    """(patient type choices, beta_c noise, observation noise)."""
    name = equation.name
    types = (1,) if name in ('EQ_5_A', 'EQ_5_B') else (1, 2, 3)
    beta_c_noise = name == 'EQ_5_D'
    obs_noise = name.split('_')[-1] in ('B', 'C', 'D')
    return types, beta_c_noise, obs_noise


def generate_params(num_patients: int, chemo_coeff: float,
                    radio_coeff: float, window_size: int, lag: int,
                    rs: np.random.RandomState,
                    equation: Equation = Equation.EQ_5_A) -> dict:
    types, beta_c_noise, _ = _variant(equation)
    return cancer.generate_params(num_patients, chemo_coeff, radio_coeff,
                                  window_size, lag, rs,
                                  patient_type_choices=types,
                                  beta_c_noise=beta_c_noise)


def simulate_factual(params, seq_length: int, rs: np.random.RandomState,
                     equation: Equation = Equation.EQ_5_A, *, device,
                     dtype=None) -> dict:
    return cancer.simulate_factual(params, seq_length, rs, device=device,
                                   dtype=dtype,
                                   extra_noise=_variant(equation)[2])


def simulate_counterfactual_1_step(params, seq_length: int,
                                   rs: np.random.RandomState,
                                   equation: Equation = Equation.EQ_5_A, *,
                                   device, dtype=None) -> dict:
    return cancer.simulate_counterfactual_1_step(
        params, seq_length, rs, device=device, dtype=dtype,
        extra_noise=_variant(equation)[2], emit_dosage=True)


def simulate_counterfactuals_treatment_seq(
        params, seq_length: int, projection_horizon: int,
        rs: np.random.RandomState, equation: Equation = Equation.EQ_5_A, *,
        device, cf_seq_mode='sliding_treatment', dtype=None) -> dict:
    return cancer.simulate_counterfactuals_treatment_seq(
        params, seq_length, projection_horizon, rs, device=device,
        cf_seq_mode=cf_seq_mode, dtype=dtype,
        extra_noise=_variant(equation)[2], emit_dosage=True)
