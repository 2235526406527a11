"""The port's vectorized RMSN column
(`harness/vectorized_neural.py::vectorized_rmsn_sweep`) against the JAX
package's, on the CPU, with both stabilized-weight formulas
('likelihood', 'score_ratio'): 2 seeds, EQ_4_D, 16 / 2 / 2 patients, 2
epochs, dropout 0 and one batch an epoch in all four networks, on the JAX
package's cohorts and from the initial weights of each of the JAX column's
four networks (rebuilt from the network, stacked sample and seeds + 0 ..
+ 3 with `_stage_rngs`). The whole pipeline runs: both propensity fits,
the stabilized weights per seed, the SW-weighted encoder, the decoder
processing and the decoder fit, step-by-step decoding. Every seed's RMSEs
agree to rtol 1e-4. Each JAX column runs once (a module fixture)."""

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
OVERRIDES = {'prop_treat_dropout': 0.0, 'prop_hist_dropout': 0.0,
             'enc_dropout': 0.0, 'dec_dropout': 0.0, 'prop_treat_bs': 64,
             'prop_hist_bs': 64, 'enc_bs': 64, 'dec_bs': 4096}


@pytest.fixture(scope='module', params=['likelihood', 'score_ratio'])
def columns(request):
    sw_mode = request.param
    kw = dict(num_patients=dict(PATIENTS), epochs=2, n_seeds=len(SEEDS),
              seed_start=SEEDS[0],
              model_overrides=dict(OVERRIDES, sw_mode=sw_mode))
    inits = []
    with pytest.MonkeyPatch.context() as mp:
        record_jax_column_inits(mp, inits)
        ref = jax_vn.vectorized_rmsn_sweep('EQ_4_D', **kw)
        assert len(inits) == 4
        hand_over_jax_cohorts(mp, vectorized_neural)
        port_columns_from_jax_inits(mp, inits)
        ours = vectorized_neural.vectorized_rmsn_sweep(
            'EQ_4_D', device='cpu', dtype=torch.float32, **kw)
        assert inits == []
    return sw_mode, ours, ref


def test_rmsn_column_matches_jax(columns):
    sw_mode, ours, ref = columns
    assert all(len(v) == len(SEEDS) and np.isfinite(v).all()
               for v in ours.values())
    assert_columns_close(ours, ref, f'rmsn column EQ_4_D {sw_mode}')
