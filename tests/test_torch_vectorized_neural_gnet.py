"""The port's vectorized G-Net column
(`harness/vectorized_neural.py::vectorized_gnet_sweep`) against the JAX
package's, on the CPU, on EQ_4_D and cancer_sim: 2 seeds, 16 / 2 / 2
patients, 2 epochs, dropout 0, one batch an epoch, 2 Monte-Carlo samples,
on the JAX package's cohorts (so the same holdout split) and from the JAX
column's initial weights (rebuilt from its network, stacked sample and
seeds with `_stage_rngs`). The n-step RMSEs hold each seed's Monte-Carlo
rollouts with its holdout residuals, the rows drawn from
``RandomState(seed)`` in the JAX order. Every seed's RMSEs agree to rtol
1e-4. Each JAX column runs once (a module fixture)."""

import numpy as np
import pytest
import torch

from insite_tpu.harness import vectorized_neural as jax_vn
from insite_tpu_torch.harness import vectorized_neural
from torch_handover import (assert_columns_close, hand_over_jax_cohorts,
                            port_columns_from_jax_inits,
                            record_jax_column_inits)

torch.set_num_threads(1)

SEEDS = (0, 1)
PATIENTS = {'train': 16, 'val': 2, 'test': 2}
OVERRIDES = {'dropout_rate': 0.0, 'batch_size': 64}


@pytest.fixture(scope='module', params=['EQ_4_D', 'cancer_sim'])
def columns(request):
    dataset = request.param
    kw = dict(num_patients=dict(PATIENTS), epochs=2, n_seeds=len(SEEDS),
              seed_start=SEEDS[0], mc_samples=2,
              model_overrides=dict(OVERRIDES))
    inits = []
    with pytest.MonkeyPatch.context() as mp:
        record_jax_column_inits(mp, inits)
        ref = jax_vn.vectorized_gnet_sweep(dataset, **kw)
        assert len(inits) == 1
        hand_over_jax_cohorts(mp, vectorized_neural)
        port_columns_from_jax_inits(mp, inits)
        ours = vectorized_neural.vectorized_gnet_sweep(
            dataset, device='cpu', dtype=torch.float32, **kw)
        assert inits == []
    return dataset, ours, ref


def test_gnet_column_matches_jax(columns):
    dataset, ours, ref = columns
    assert all(len(v) == len(SEEDS) and np.isfinite(v).all()
               for v in ours.values())
    assert_columns_close(ours, ref, f'gnet column {dataset}')
