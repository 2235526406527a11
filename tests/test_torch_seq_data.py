"""The sequence-data layer the sequence-to-sequence baselines stand on:
`explode_trajectories`, `process_sequential`, `process_sequential_test` with
an encoder's representations, `process_autoregressive_test`, and the
collection's `process_data_encoder`, `process_data_decoder`,
`process_propensity_train_f`, `split_train_f_holdout` and
`explode_cf_treatment_seq`, each against the JAX package on copies of the
same raw subsets of one EQ_4 and one tumor collection.

Both packages do this in numpy, so every array of every resulting dict is
held equal (`assert_array_equal`), not merely close."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS

PH = 5
SEED = 3
SIZES = {'train': 24, 'val': 6, 'test': 4}
CASES = [('EQ_4_C', 'multiclass'), ('cancer_sim', 'multilabel')]


def _assert_same_dict(ours: dict, ref: dict):
    assert list(ours) == list(ref)
    for k in ref:
        o, r = np.asarray(ours[k]), np.asarray(ref[k])
        assert o.shape == r.shape and o.dtype == r.dtype, k
        np.testing.assert_array_equal(o, r, err_msg=k)


@pytest.fixture(scope='module', params=CASES, ids=[c[0] for c in CASES])
def raw_collection(request):
    """An unprocessed JAX collection; every test works on copies."""
    name, mode = request.param
    ref = jax_make_collection(name, SIZES, SEED, 2.0, treatment_mode=mode,
                              dtype=jnp.float64)
    return name, mode, ref


@pytest.fixture
def pair(raw_collection):
    """(ours, ref): the port's collection over copies of the raw subsets of
    a copy of the JAX collection."""
    name, mode, ref = raw_collection
    ref = copy.deepcopy(ref)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, name, projection_horizon=PH,
        treatment_mode=mode, seed=SEED)
    return ours, ref


class StubEncoder:
    """Representations and predictions from a seed and the dataset's shape
    alone, so both packages' collections see the same arrays."""

    def __init__(self, dim_r=3):
        self.dim_r = dim_r

    def _draw(self, ds, width, salt):
        n, t = ds.data['current_covariates'].shape[:2]
        return np.random.RandomState(1000 * salt + n).randn(n, t, width)

    def get_representations(self, ds):
        return self._draw(ds, self.dim_r, 1)

    def get_predictions(self, ds):
        return self._draw(ds, 1, 2)

    def get_propensity_scores(self, ds):
        n, t, k = ds.data['current_treatments'].shape
        return np.random.RandomState(self.dim_r + n).uniform(
            0.1, 0.9, (n, t, k))


def _seeded_extras(ds, seed, vitals=True, weights=True):
    """Add a vitals stream and stabilized weights to a processed dataset."""
    rng = np.random.RandomState(seed)
    n, t = ds.data['outputs'].shape[:2]
    if vitals:
        ds.data['vitals'] = rng.randn(n, t, 2)
    if weights:
        ds.data['stabilized_weights'] = rng.uniform(0.5, 2.0, (n, t))


def test_explode_trajectories_matches_jax(pair):
    ours, ref = pair
    for c in (ours, ref):
        c.process_data_encoder()
        _seeded_extras(c.train_f, 0)
        c.train_f.explode_trajectories(PH)
    o, r = ours.train_f, ref.train_f
    assert o.exploded and r.exploded
    _assert_same_dict(o.data, r.data)
    lengths = ref.val_f.data['sequence_lengths'].astype(int)
    # without the optional streams, on another subset
    for c in (ours, ref):
        c.val_f.explode_trajectories(PH)
    _assert_same_dict(ours.val_f.data, ref.val_f.data)
    assert len(ours.val_f) == np.maximum(lengths - PH, 0).sum()
    assert 'vitals' not in ours.val_f.data
    assert {'vitals', 'next_vitals', 'stabilized_weights'} <= set(o.data)


@pytest.mark.parametrize('weights', [False, True])
def test_process_sequential_matches_jax(pair, weights):
    ours, ref = pair
    enc = StubEncoder()
    for c in (ours, ref):
        c.process_data_encoder()
        _seeded_extras(c.train_f, 1, vitals=False, weights=weights)
        c.train_f.process_sequential(enc.get_representations(c.train_f), PH,
                                     save_encoder_r=True)
    o, r = ours.train_f, ref.train_f
    assert o.processed_sequential and o.exploded
    _assert_same_dict(o.data, r.data)
    _assert_same_dict(o.data_original, r.data_original)
    np.testing.assert_array_equal(o.encoder_r, r.encoder_r)
    assert ('stabilized_weights' in o.data) == weights
    # the originals are set aside as copies
    assert o.data_original['outputs'] is not o.data['outputs']
    # processing twice is a no-op
    assert o.process_sequential(None, PH) is o.data


@pytest.mark.parametrize('encoder_outputs_ndim', [3, 2])
def test_sequential_and_autoregressive_test_rows_match_jax(
        pair, encoder_outputs_ndim):
    ours, ref = pair
    enc = StubEncoder(dim_r=4)
    for c in (ours, ref):
        ds = c.test_cf_treatment_seq
        c._process(ds)
        _seeded_extras(ds, 2, weights=False)
        r_test = enc.get_representations(ds)
        out_test = enc.get_predictions(ds)
        if encoder_outputs_ndim == 2:
            out_test = out_test[..., 0]
        ds.process_sequential_test(PH, encoder_r=r_test, save_encoder_r=True)
        c.after_sequential = (copy.deepcopy(ds.data), ds.encoder_r)
        ds.process_autoregressive_test(r_test, out_test, PH,
                                       save_encoder_r=True)
    o, r = ours.test_cf_treatment_seq, ref.test_cf_treatment_seq
    _assert_same_dict(ours.after_sequential[0], ref.after_sequential[0])
    np.testing.assert_array_equal(ours.after_sequential[1],
                                  ref.after_sequential[1])
    assert {'init_state', 'vitals'} <= set(ours.after_sequential[0])
    assert o.processed_sequential and o.processed_autoregressive
    _assert_same_dict(o.data, r.data)
    _assert_same_dict(o.data_processed_seq, r.data_processed_seq)
    _assert_same_dict(o.data_original, r.data_original)
    np.testing.assert_array_equal(o.encoder_r, r.encoder_r)
    assert o.data['current_covariates'].shape[1] == PH
    assert 'vitals' in o.data


def test_process_data_encoder_matches_jax(pair):
    ours, ref = pair
    for c in (ours, ref):
        assert not c.processed_data_encoder
        c.process_data_encoder()
        assert c.processed_data_encoder and not c.processed_data_multi
    for subset in ('train_f', 'val_f', 'test_cf_one_step'):
        _assert_same_dict(getattr(ours, subset).data,
                          getattr(ref, subset).data)
    assert not ours.test_cf_treatment_seq.processed


def test_process_data_decoder_matches_jax(pair):
    ours, ref = pair
    enc = StubEncoder()
    for c in (ours, ref):
        c.process_data_encoder()
        c.process_data_decoder(enc, save_encoder_r=True)
        assert c.processed_data_decoder
    for subset in ('train_f', 'val_f', 'test_cf_treatment_seq'):
        o, r = getattr(ours, subset), getattr(ref, subset)
        _assert_same_dict(o.data, r.data)
        _assert_same_dict(o.data_original, r.data_original)
        np.testing.assert_array_equal(o.encoder_r, r.encoder_r)
    o, r = ours.test_cf_treatment_seq, ref.test_cf_treatment_seq
    assert o.processed_autoregressive
    _assert_same_dict(o.data_processed_seq, r.data_processed_seq)


def test_process_propensity_train_f_matches_jax(pair):
    ours, ref = pair
    for c in (ours, ref):
        c.process_data_encoder()
        c.process_propensity_train_f(StubEncoder(1), StubEncoder(2))
    sw = ours.train_f.data['stabilized_weights']
    np.testing.assert_array_equal(sw, ref.train_f.data['stabilized_weights'])
    assert sw.shape == ours.train_f.data['outputs'].shape[:2]
    assert (sw > 0).all() and sw.std() > 0


def test_split_train_f_holdout_matches_jax(pair):
    """The handed-over collection carries the seed, so its holdout split
    is the source collection's."""
    ours, ref = pair
    assert ours.seed == ref.seed == SEED
    for c in (ours, ref):
        c.process_data_encoder()
        c.split_train_f_holdout(holdout_ratio=0.2)
    _assert_same_dict(ours.train_f.data, ref.train_f.data)
    _assert_same_dict(ours.train_f_holdout.data, ref.train_f_holdout.data)
    n_hold = int(np.ceil(SIZES['train'] * 0.2))
    assert len(ours.train_f_holdout) == n_hold
    assert len(ours.train_f) == SIZES['train'] - n_hold
    # a second call, and a ratio of 0 on a fresh collection, change nothing
    before = ours.train_f.data['outputs']
    ours.split_train_f_holdout(holdout_ratio=0.5)
    assert ours.train_f.data['outputs'] is before


def test_split_without_holdout_and_mc_views(pair):
    ours, ref = pair
    for c in (ours, ref):
        c.process_data_multi()
        c.split_train_f_holdout(holdout_ratio=0.0)
        c.explode_cf_treatment_seq(mc_samples=3)
        c.explode_cf_treatment_seq(mc_samples=5)    # kept from the first call
    assert not hasattr(ours, 'train_f_holdout')
    assert len(ours.test_cf_treatment_seq_mc) == \
        len(ref.test_cf_treatment_seq_mc) == 3
    assert all(ds is ours.test_cf_treatment_seq
               for ds in ours.test_cf_treatment_seq_mc)


def test_collection_flags_match_jax(pair):
    ours, ref = pair
    for flag in ('processed_data_encoder', 'processed_data_decoder',
                 'processed_data_multi', 'processed_data_msm',
                 'autoregressive', 'has_vitals', 'treatment_mode',
                 'projection_horizon'):
        assert getattr(ours, flag) == getattr(ref, flag), flag
    assert ours.train_f.exploded is False
