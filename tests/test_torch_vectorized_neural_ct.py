"""The port's vectorized CT column (`harness/vectorized_neural.py`)
against the JAX package's, on the CPU: 2 seeds, 16 / 2 / 2 patients, 2
epochs, dropout 0 and one batch an epoch, on the JAX package's cohorts
(handed over with `convert.collection_from_numpy`) and from the JAX
column's initial weights (rebuilt from its network and stacked sample with
`_stage_rngs`, carried over with `convert.stacked_params_from_flax`); both
train in float32. Every seed's RMSEs agree to rtol 1e-4 on EQ_4_D (the
cancer_sim case is G-Net's, `test_torch_vectorized_neural_lstm.py`). The
JAX column runs once (a module fixture)."""

import numpy as np
import pytest
import torch

from insite_tpu_torch.harness import vectorized_neural
from torch_handover import (assert_columns_close, hand_over_jax_cohorts,
                            jax_ct_column_with_init,
                            port_columns_from_jax_inits)

torch.set_num_threads(1)

SEEDS = (0, 1)
PATIENTS = {'train': 16, 'val': 2, 'test': 2}
OVERRIDES = {'dropout_rate': 0.0, 'batch_size': 256}


@pytest.fixture(scope='module')
def columns():
    dataset = 'EQ_4_D'
    kw = dict(num_patients=dict(PATIENTS), epochs=2,
              model_overrides=dict(OVERRIDES))
    with pytest.MonkeyPatch.context() as mp:
        ref, inits = jax_ct_column_with_init(mp, SEEDS, dataset_name=dataset,
                                             **kw)
        hand_over_jax_cohorts(mp, vectorized_neural)
        port_columns_from_jax_inits(mp, inits)
        ours = vectorized_neural.vectorized_ct_sweep(
            dataset, n_seeds=len(SEEDS), seed_start=SEEDS[0], device='cpu',
            dtype=torch.float32, **kw)
        assert inits == []
    return dataset, ours, ref


def test_ct_column_matches_jax(columns):
    dataset, ours, ref = columns
    assert all(len(v) == len(SEEDS) for v in ours.values())
    assert all(np.isfinite(v).all() for v in ours.values())
    assert_columns_close(ours, ref, f'ct column {dataset}')
