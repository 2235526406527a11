"""The port's MSM against the JAX package's, in float64 on the CPU, on one
collection made by the JAX package and handed over with
`convert.collection_from_numpy` (EQ_4_D and cancer_sim, 30 / 6 / 6 patients,
multilabel): both propensity models, the stabilized weights, each of the
``projection_horizon + 1`` regressors, both prediction functions, the RMSE
protocol, and predictions from `convert.msm_state_from_numpy` state alone.
Then the dense all-prefix feature functions against the exploded-row ones, as
`tests/test_msm_dense.py` holds them for the JAX package.

Tolerances: the fit is the same numpy / scipy code on the same float64
inputs, so everything is held to rtol 1e-9 and in fact comes out equal to
the last bit (largest deviation found: 0.0 on every quantity, both
datasets); dense against exploded features to rtol 1e-12."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.models.msm import MSM as JaxMSM
from insite_tpu.models.msm import MSMConfig as JaxMSMConfig
from insite_tpu.models.msm import linreg_fit as jax_linreg_fit
from insite_tpu.models.msm import logistic_fit as jax_logistic_fit
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.harness.runner import _dims_from_collection
from insite_tpu_torch.models.msm import (MSM, MSMConfig, linreg_fit,
                                         logistic_fit, logistic_proba)

PH = 5
SIZES = {'train': 30, 'val': 6, 'test': 6}
RTOL = 1e-9
DATASETS = ['EQ_4_D', 'cancer_sim']


def _close(ours, ref, what, rtol=RTOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, what
    dev = float(np.max(np.abs(ours - ref) /
                       np.maximum(np.abs(ref), 1e-300))) if ref.size else 0.0
    print(f'{what}: largest relative deviation {dev:.3e}')
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0, err_msg=what)


def _collections(name):
    ref = jax_make_collection(name, SIZES, 0, 2.0,
                              treatment_mode='multilabel', dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, name, projection_horizon=PH,
        treatment_mode='multilabel', seed=0)
    return ours, ref


@pytest.fixture(scope='module', params=DATASETS)
def fitted(request):
    """(port MSM, JAX MSM), both fitted on the same collection."""
    ours, ref = _collections(request.param)
    ref.process_data_multi()
    ours.process_data_multi()
    dims = _dims_from_collection(ours)
    assert dims['dim_treatments'] == (1 if 'EQ_4' in request.param else 2)
    m_ref = JaxMSM(JaxMSMConfig(max_epochs=100, **dims), ref).fit()
    m_ours = MSM(MSMConfig(max_epochs=100, **dims), ours).fit()
    return m_ours, m_ref


@pytest.mark.parametrize('which', ['prop_treat', 'prop_hist'])
def test_propensity_models_match_jax(fitted, which):
    ours, ref = fitted
    (W, b), (W_ref, b_ref) = getattr(ours, which), getattr(ref, which)
    _close(W, W_ref, f'{which} W')
    _close(b, b_ref, f'{which} b')
    assert W.shape[0] == ours.cfg.dim_treatments and np.abs(W).max() > 0
    scores = ours.get_propensity_scores(ours.collection.train_f,
                                        which.split('_')[1])
    _close(scores, ref.get_propensity_scores(ref.collection.train_f,
                                             which.split('_')[1]),
           f'{which} scores')
    # the treatment column is quasi-separable: scores saturate at 1.0
    assert ((scores > 0) & (scores <= 1)).all()
    assert (scores[:, :ours.lag_features] == 0.5).all()


def test_stabilized_weights_match_jax(fitted):
    ours, ref = fitted
    sw = ours.collection.train_f.data['stabilized_weights']
    _close(sw, ref.collection.train_f.data['stabilized_weights'],
           'stabilized_weights')
    assert sw.shape == ours.collection.train_f.data['outputs'].shape[:2]
    assert (sw > 0).all()


@pytest.mark.parametrize('tau', range(PH + 1))
def test_regressors_match_jax(fitted, tau):
    ours, ref = fitted
    assert len(ours.regressors) == len(ref.regressors) == PH + 1
    _close(ours.regressors[tau], ref.regressors[tau], f'regressor {tau}')
    for a, b in zip(ours._regressor_design(tau), ref._regressor_design(tau)):
        _close(a, b, f'regressor design {tau}')


def test_predictions_and_rmses_match_jax(fitted):
    ours, ref = fitted
    one, one_ref = (m.collection.test_cf_one_step for m in fitted)
    seq, seq_ref = (m.collection.test_cf_treatment_seq for m in fitted)
    pred = ours.get_predictions(one)
    _close(pred, ref.get_predictions(one_ref), 'get_predictions')
    assert pred.shape == one.data['outputs'].shape
    auto = ours.get_autoregressive_predictions(seq)
    _close(auto, ref.get_autoregressive_predictions(seq_ref),
           'get_autoregressive_predictions')
    assert auto.shape == (len(seq.data['sequence_lengths']), PH, 1)
    _close(ours.get_normalised_masked_rmse(one, one_step_counterfactual=True),
           ref.get_normalised_masked_rmse(one_ref,
                                          one_step_counterfactual=True),
           '1-step RMSEs')
    rmses = ours.get_normalised_n_step_rmses(seq)
    _close(rmses, ref.get_normalised_n_step_rmses(seq_ref), 'n-step RMSEs')
    assert rmses.shape == (PH,) and np.isfinite(rmses).all()


def test_predictions_from_carried_state_alone(fitted):
    """An unfitted port MSM given the JAX model's arrays predicts what the
    JAX model predicts."""
    _, ref = fitted
    name = ref.collection.equation_name
    ours_coll, _ = _collections('cancer_sim' if name == 'CANCER_SIM'
                                else name)
    ours_coll.process_data_multi()
    m = MSM(MSMConfig(**_dims_from_collection(ours_coll)), ours_coll)
    assert m.prop_treat is None and m.regressors == []
    assert convert.msm_state_from_numpy(
        m, ref.prop_treat, ref.prop_hist, ref.regressors) is m
    _close(m.get_predictions(ours_coll.test_cf_one_step),
           ref.get_predictions(ref.collection.test_cf_one_step),
           'get_predictions from state')
    _close(m.get_autoregressive_predictions(ours_coll.test_cf_treatment_seq),
           ref.get_autoregressive_predictions(
               ref.collection.test_cf_treatment_seq),
           'get_autoregressive_predictions from state')
    m.compute_stabilized_weights()
    _close(ours_coll.train_f.data['stabilized_weights'],
           ref.collection.train_f.data['stabilized_weights'],
           'stabilized_weights from state')
    with pytest.raises(ValueError, match='regressors'):
        convert.msm_state_from_numpy(m, ref.prop_treat, ref.prop_hist,
                                     ref.regressors[:-1])


def test_solvers_match_jax_on_seeded_data():
    rng = np.random.RandomState(0)
    X = rng.randn(200, 4)
    Y = (rng.rand(200, 2) < 1 / (1 + np.exp(-X[:, :2]))).astype(float)
    (W, b), (W_ref, b_ref) = logistic_fit(X, Y, 50), jax_logistic_fit(X, Y,
                                                                      50)
    _close(W, W_ref, 'logistic W')
    _close(b, b_ref, 'logistic b')
    p = logistic_proba(W, b, X)
    assert p.shape == (200, 2) and ((p > 0) & (p < 1)).all()
    # the fit moves towards the generating weights (1 on its own column)
    assert W[0, 0] > 0.5 and W[1, 1] > 0.5
    w = rng.uniform(0.5, 2.0, 200)
    T = X @ rng.randn(4, 3) + 0.7
    for sw in (None, w):
        coef = linreg_fit(X, T, sw)
        _close(coef, jax_linreg_fit(X, T, sw), 'linreg')
        assert coef.shape == (5, 3)
        np.testing.assert_allclose(coef[-1], 0.7, rtol=1e-9)   # intercept


# ---------------------------------------------------------------------------
# dense all-prefix features == exploded-row features, for the port

def test_dense_propensity_fit_features_match_exploded(fitted):
    m, _ = fitted
    coll = m.collection
    lag = m.lag_features
    train = m._exploded(coll.train_f, min_length=lag)
    last = m._last_entries(train.data['active_entries'])
    ref_treat = m._inputs_treat(train.data)
    ref_hist = m._inputs_hist(train.data)
    ref_out = (train.data['current_treatments'] * last).sum(1)

    dense_treat, dense_out = m._propensity_design('treat')
    dense_hist, dense_out_h = m._propensity_design('hist')
    np.testing.assert_allclose(dense_treat, ref_treat, rtol=1e-12)
    np.testing.assert_allclose(dense_hist, ref_hist, rtol=1e-12)
    np.testing.assert_allclose(dense_out, ref_out, rtol=1e-12)
    np.testing.assert_array_equal(dense_out, dense_out_h)
    # the exploded copy left the collection's rows alone
    assert not coll.train_f.exploded and train.exploded


@pytest.mark.parametrize('tau', [0, 2, 5])
def test_dense_regressor_features_match_exploded(fitted, tau):
    m, _ = fitted
    coll = m.collection
    train = m._exploded(coll.train_f, min_length=m.lag_features + tau)
    last = m._last_entries(train.data['active_entries'])
    ref_in = m._inputs_regressor(train.data, projection_horizon=tau, tau=tau)
    ref_out = (train.data['outputs'] * last).sum(1)
    ref_sw = m._sample_weights(train.data, tau)

    dense_in, dense_out, dense_sw = m._regressor_design(tau)
    np.testing.assert_allclose(dense_in, ref_in, rtol=1e-12)
    np.testing.assert_allclose(dense_out, ref_out, rtol=1e-12)
    np.testing.assert_allclose(dense_sw, ref_sw, rtol=1e-12)


def test_dense_prediction_features_match_exploded(fitted):
    m, _ = fitted
    ds = m.collection.test_cf_one_step
    before = copy.deepcopy(ds.data)
    max_len = int(max(ds.data['sequence_lengths']))
    exploded = m._exploded(ds, min_length=m.lag_features,
                           only_active_entries=False, max_length=max_len)
    ref = m._inputs_regressor(exploded.data, 0, 0)
    dense = m._dense_regressor(ds.data, tau=0)
    n, Tl = dense.shape[:2]
    np.testing.assert_allclose(dense.reshape(n * Tl, -1), ref, rtol=1e-12)
    # forcing every entry active wrote into the copy only
    for k, v in before.items():
        np.testing.assert_array_equal(ds.data[k], v, err_msg=k)
