"""The data layer: `process_data_pkpd`, `process_sequential_test` and
`process_sequential_multi` of the port, on copies of the same raw subsets
of a JAX collection, give the JAX package's arrays exactly."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from insite_tpu.data.collection import PkpdDatasetCollection as JaxCollection
from insite_tpu.data.dataset import active_entries_from_lengths as jax_active
from insite_tpu.data.dataset import one_hot_binary as jax_one_hot
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.data.dataset import (active_entries_from_lengths,
                                           one_hot_binary)


def _assert_same_dict(ours: dict, ref: dict):
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.fixture(scope='module', params=['multiclass', 'multilabel'])
def processed_pair(request):
    ref = JaxCollection(2.0, {'train': 24, 'val': 6, 'test': 2}, 'EQ_4_C',
                        seed=1, treatment_mode=request.param,
                        dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, 'EQ_4_C', projection_horizon=5,
        treatment_mode=request.param)
    ref.process_data_multi()
    ours.process_data_multi()
    return ours, ref


@pytest.mark.parametrize('subset', SUBSETS)
def test_processed_subsets_match_jax(processed_pair, subset):
    ours, ref = (getattr(c, subset) for c in processed_pair)
    assert ours.processed and ref.processed
    _assert_same_dict(ours.data, ref.data)
    for k, v in ref.scaling_params.items():
        np.testing.assert_array_equal(ours.scaling_params[k], v)


def test_sequential_test_and_multi_views_match_jax(processed_pair):
    ours, ref = (c.test_cf_treatment_seq for c in processed_pair)
    assert ours.processed_sequential and ours.processed_autoregressive
    _assert_same_dict(ours.data_processed_seq, ref.data_processed_seq)
    _assert_same_dict(ours.data_original, ref.data_original)
    np.testing.assert_array_equal(ours.data['future_past_split'],
                                  ours.data['sequence_lengths'] - 5)
    assert 'future_past_split' not in ours.data_original


def test_one_hot_and_active_entries_match_jax():
    rng = np.random.RandomState(0)
    app = rng.randint(0, 2, (5, 7)).astype(np.float64)
    np.testing.assert_array_equal(one_hot_binary(app), jax_one_hot(app))
    lengths = rng.randint(0, 9, 5)
    np.testing.assert_array_equal(active_entries_from_lengths(lengths, 8),
                                  jax_active(lengths, 8))
