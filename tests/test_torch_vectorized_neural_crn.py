"""The port's vectorized CRN column
(`harness/vectorized_neural.py::vectorized_enc_dec_sweep`) against the JAX
package's, on the CPU (EDCT's: `test_torch_vectorized_neural_edct.py`): 2
seeds, EQ_4_D, 16 / 2 / 2 patients, 2 epochs, dropout 0 and one batch an
epoch in both stages (the decoder's batch widened past its rolling-origin
rows), on the JAX package's cohorts and from the initial weights of both of
the JAX column's stages (each rebuilt from the stage's network, stacked
sample and seeds with `_stage_rngs`: the encoder's from the seeds, the
decoder's from seeds + 1). The whole pipeline runs: encoder fit, decoder
processing on the encoder's representations, decoder fit, step-by-step
decoding. Every seed's RMSEs agree to rtol 1e-4. The JAX column runs once
(a module fixture)."""

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
OVERRIDES = {'enc_dropout_rate': 0.0, 'dec_dropout_rate': 0.0,
             'enc_batch_size': 64, 'dec_batch_size': 4096}


METHOD = 'crn'


@pytest.fixture(scope='module')
def columns():
    method = METHOD
    kw = dict(num_patients=dict(PATIENTS), epochs=2,
              model_overrides=dict(OVERRIDES), n_seeds=len(SEEDS),
              seed_start=SEEDS[0])
    inits = []
    with pytest.MonkeyPatch.context() as mp:
        record_jax_column_inits(mp, inits)
        ref = jax_vn.vectorized_enc_dec_sweep(method, 'EQ_4_D', **kw)
        assert len(inits) == 2
        hand_over_jax_cohorts(mp, vectorized_neural)
        port_columns_from_jax_inits(mp, inits)
        ours = vectorized_neural.vectorized_enc_dec_sweep(
            method, 'EQ_4_D', device='cpu', dtype=torch.float32, **kw)
        assert inits == []
    return method, ours, ref


def test_enc_dec_column_matches_jax(columns):
    method, ours, ref = columns
    assert all(len(v) == len(SEEDS) and np.isfinite(v).all()
               for v in ours.values())
    assert_columns_close(ours, ref, f'{method} column EQ_4_D')
