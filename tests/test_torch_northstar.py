"""The north-star pipeline: the port's design -> QR -> STLSQ -> fine-tune ->
RMSE stages on the JAX package's cohort against JAX `fused_northstar`, and
the port's own pipeline end to end on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.harness.northstar import _sim_design_qr
from insite_tpu.harness.northstar import fused_northstar as jax_northstar
from insite_tpu_torch.harness.northstar import (discover_and_finetune,
                                                fused_northstar,
                                                simulate_cohort)

N, SEED = 120, 0
TIMINGS = ('t_sim_design', 't_stlsq', 't_finetune', 't_metric', 'total')


def test_stages_on_jax_cohort_match_jax_northstar():
    ref = jax_northstar(N, seed=SEED, equation_name='EQ_4_D',
                        projection_horizon=1)
    _, cohort = _sim_design_qr(jax.random.PRNGKey(SEED), N, 60, 'EQ_4_D',
                               JaxLibrary(n_inputs=3), 2.0, jnp.float64)
    cohort = tuple(torch.from_numpy(np.array(a)) for a in cohort)
    assert cohort[0].dtype == torch.float64
    r = discover_and_finetune(cohort, projection_horizon=1)

    np.testing.assert_array_equal(np.abs(r['coefs']) > 1e-3,
                                  np.abs(ref['coefs']) > 1e-3)
    # f64; QR by LAPACK here and by XLA there (R up to row signs), then the
    # same host STLSQ
    np.testing.assert_allclose(r['coefs'], ref['coefs'], rtol=1e-6,
                               atol=1e-12)
    # the same LM update sequence on the same cohort (measured: ~1e-12)
    np.testing.assert_allclose(r['rmse_orig'], ref['rmse_orig'], rtol=1e-4)
    np.testing.assert_allclose(r['rmse_all'], ref['rmse_all'], rtol=1e-4)


def test_own_pipeline_end_to_end_on_cpu():
    r = fused_northstar(N, seed=SEED, device='cpu')
    assert 'Treatment 0: x_dot =' in r['global_equation_string']
    assert 'Treatment 1: x_dot =' in r['global_equation_string']
    assert r['preds'].shape == (N, 59)
    assert torch.isfinite(r['preds']).all()
    assert r['rmse_orig'] < 0.2               # INSITE-level factual fit (%)
    for k in TIMINGS:
        assert r[k] >= 0.0


def test_a_fit_with_no_support_still_predicts():
    """A threshold that removes every coefficient: the fine-tune has
    nothing to move, so every row rolls out the zero model, which keeps
    its first observation."""
    cohort = simulate_cohort(40, SEED, device='cpu', dtype=torch.float64)
    r = discover_and_finetune(cohort, threshold=1e9, projection_horizon=1)
    assert not r['coefs'].any()
    prev = cohort[0][:, :-1]
    assert torch.equal(r['preds'], prev[:, :1].expand_as(prev))
    assert np.isfinite(r['rmse_orig']) and np.isfinite(r['rmse_all'])
