"""The RMSE protocol: the port's metric functions against the JAX package's
on seeded arrays."""

from types import SimpleNamespace

import numpy as np
import pytest

from insite_tpu.eval import metrics as jm
from insite_tpu_torch.eval import metrics as tm

ROWS, T, PH = 40, 12, 5


def _dataset(seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, T + 1, ROWS)
    active = (np.arange(T)[None, :] < lengths[:, None])[..., None] * 1.0
    outputs = rng.randn(ROWS, T, 1)
    sp = {'output_means': 20.0, 'output_stds': 7.5}
    seq_out = rng.randn(ROWS, PH, 1)
    seq_out[3, 2, 0] = np.nan             # a row the n-step protocol drops
    data = {'active_entries': active, 'outputs': outputs,
            'unscaled_outputs': outputs * 7.5 + 20.0}
    seq = {'active_entries': np.ones((ROWS, PH, 1)), 'outputs': seq_out,
           'unscaled_outputs': seq_out * 7.5 + 20.0}
    return (SimpleNamespace(data=data, data_processed_seq=seq,
                            scaling_params=sp, norm_const=50.0), rng)


@pytest.mark.parametrize('unscale', [True, False])
@pytest.mark.parametrize('one_step', [True, False])
def test_normalised_masked_rmse_matches_jax(unscale, one_step):
    ds, rng = _dataset(0)
    preds = ds.data['outputs'] + 0.1 * rng.randn(ROWS, T, 1)
    kw = dict(unscale=unscale, one_step_counterfactual=one_step)
    ours = tm.normalised_masked_rmse(ds, preds, **kw)
    assert ours == jm.normalised_masked_rmse(ds, preds, **kw)
    assert len(ours) == (3 if one_step else 2)
    assert all(isinstance(v, float) for v in ours)


@pytest.mark.parametrize('unscale', [True, False])
def test_normalised_n_step_rmses_match_jax(unscale):
    ds, rng = _dataset(1)
    preds = np.nan_to_num(ds.data_processed_seq['outputs']) + \
        0.1 * rng.randn(ROWS, PH, 1)
    ours = tm.normalised_n_step_rmses(ds, preds, unscale=unscale)
    np.testing.assert_array_equal(
        ours, jm.normalised_n_step_rmses(ds, preds, unscale=unscale))
    assert ours.shape == (PH,) and np.isfinite(ours).all()
