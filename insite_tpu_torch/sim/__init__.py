"""PKPD cohort simulator (factual and counterfactual test sets)."""

from insite_tpu_torch.sim.pkpd import (
    Equation, generate_params, get_scaling_params,
    simulate_counterfactual_1_step, simulate_counterfactuals_treatment_seq,
    simulate_factual)

__all__ = ['Equation', 'generate_params', 'simulate_factual',
           'simulate_counterfactual_1_step',
           'simulate_counterfactuals_treatment_seq', 'get_scaling_params']
