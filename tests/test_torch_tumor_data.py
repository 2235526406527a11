"""Tumor-family data: `one_hot_pairs`, `process_data_tumor` with and
without the continuous-treatment covariate, the n-step evaluation rows
(which carry the patient types), and whole collections, each against the
JAX package in float64 on the CPU.

Tolerances: the collections' discrete arrays are equal; volumes agree to
rtol 1e-10, and so do the scaling parameters; processing is numpy in both
packages, so its outputs on the same raw data are equal."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.data.dataset import SeqDataset as JaxSeqDataset
from insite_tpu.data.dataset import one_hot_pairs as jax_one_hot_pairs
from insite_tpu.data.processing import process_data_tumor as jax_process
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import (SUBSETS,
                                              CancerDatasetCollection,
                                              ContinuousDatasetCollection,
                                              make_collection)
from insite_tpu_torch.data.dataset import SeqDataset, one_hot_pairs
from insite_tpu_torch.data.processing import process_data_tumor
from insite_tpu_torch.sim import cancer
from insite_tpu_torch.sim.tumor import TUMOUR_DEATH_THRESHOLD

SEQ, PH = 60, 5
SIZES = {'train': 40, 'val': 4, 'test': 4}
F64 = dict(device='cpu', dtype=torch.float64)
DATASETS = ['cancer_sim', 'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D']


def _assert_dicts_equal(ref: dict, out: dict, rtol=0.0):
    assert set(ref) == set(out)
    for k in ref:
        r, o = np.asarray(ref[k]), np.asarray(out[k])
        assert r.shape == o.shape, k
        if r.dtype.kind == 'f' and rtol:
            np.testing.assert_allclose(o, r, rtol=rtol, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(o, r, err_msg=k)


def _assert_scaling_close(ref, out):
    for r, o in zip(ref, out):
        assert set(r) == set(o)
        for k in r:
            np.testing.assert_allclose(o[k], r[k], rtol=1e-10, err_msg=k)


def test_one_hot_pairs_matches_jax():
    rs = np.random.RandomState(0)
    a = rs.randint(0, 2, (7, 11)).astype(np.float64)
    b = rs.randint(0, 2, (7, 11)).astype(np.float64)
    out = one_hot_pairs(a, b)
    np.testing.assert_array_equal(out, jax_one_hot_pairs(a, b))
    assert out.shape == (7, 11, 4)
    np.testing.assert_array_equal(out.argmax(-1), a + 2 * b)


def _raw_cohort(name, seed=1):
    """A factual cohort and a 1-step test set of the variant, drawn by the
    port, with the factual set's scaling parameters."""
    rs = np.random.RandomState(seed)
    emit = name.startswith('EQ_5')
    params = cancer.generate_params(12, 2.0, 2.0, 15, 0, rs)
    fact = cancer.simulate_factual(params, SEQ, rs, **F64)
    params = cancer.generate_params(3, 2.0, 2.0, 15, 0, rs)
    one = cancer.simulate_counterfactual_1_step(params, SEQ, rs,
                                                emit_dosage=emit, **F64)
    if name in ('EQ_5_A', 'EQ_5_B'):        # a single patient type
        fact['patient_types'][:] = 1
        one['patient_types'][:] = 1
    return (fact, one), cancer.get_scaling_params(fact)


@pytest.mark.parametrize('name,continuous', [
    ('CANCER_SIM', False), ('EQ_5_A', True), ('EQ_5_C', True),
    ('EQ_5_D', False)])
@pytest.mark.parametrize('mode', ['multiclass', 'multilabel'])
def test_process_data_tumor_matches_jax(name, continuous, mode):
    raws, scaling = _raw_cohort(name)
    for raw in raws:
        ours = SeqDataset(copy.deepcopy(raw), 'train', TUMOUR_DEATH_THRESHOLD)
        ref = JaxSeqDataset(copy.deepcopy(raw), 'train',
                            TUMOUR_DEATH_THRESHOLD)
        process_data_tumor(ours, scaling, mode, name, continuous)
        jax_process(ref, scaling, mode, name, continuous)
        _assert_dicts_equal(ref.data, ours.data)
        _assert_dicts_equal(ref.scaling_params, ours.scaling_params)
        n_cov = 3 if continuous else 2
        assert ours.data['current_covariates'].shape[-1] == n_cov
        assert ours.data['static_features'].shape[-1] == n_cov - 1
        assert ours.data['current_treatments'].shape[-1] == \
            (4 if mode == 'multiclass' else 2)
        # processing twice is a no-op
        assert process_data_tumor(ours, scaling, mode, name,
                                  continuous) is ours.data


def _collections(name, mode='sliding_treatment'):
    ref = jax_make_collection(name, SIZES, 3, 2.0, cf_seq_mode=mode,
                              dtype=jnp.float64)
    ours = make_collection(name, SIZES, 3, 2.0, cf_seq_mode=mode, **F64)
    return ours, ref


@pytest.mark.parametrize('name', DATASETS)
def test_collection_matches_jax(name):
    mode = 'random_trajectories' if name == 'EQ_5_C' else \
        'sliding_treatment'
    ours, ref = _collections(name, mode)
    assert type(ours) is (CancerDatasetCollection if name == 'cancer_sim'
                          else ContinuousDatasetCollection)
    assert ours.norm_const == ref.norm_const == TUMOUR_DEATH_THRESHOLD
    assert ours.equation_name == ref.equation_name
    for attr in SUBSETS:
        o, r = getattr(ours, attr), getattr(ref, attr)
        _assert_dicts_equal(r.data, o.data, rtol=1e-10)
        _assert_dicts_equal(r.sim_params, o.sim_params)
    _assert_scaling_close(ref.train_scaling_params, ours.train_scaling_params)
    # one stream for all four subsets: the two test sets hold different
    # patients
    assert not np.array_equal(
        ours.test_cf_one_step.sim_params['initial_volumes'],
        ours.test_cf_treatment_seq.sim_params['initial_volumes'])


@pytest.mark.parametrize('name', ['cancer_sim', 'EQ_5_B'])
def test_processed_collection_matches_jax(name):
    """process_data_multi on both collections, EQ_5 with the dosage
    covariate: every subset, and the n-step set's evaluation rows."""
    ours, ref = _collections(name)
    continuous = name.startswith('EQ_5')
    ours.process_data_multi(include_continuous_treatment=continuous)
    ref.process_data_multi(include_continuous_treatment=continuous)
    for attr in SUBSETS:
        _assert_dicts_equal(getattr(ref, attr).data,
                            getattr(ours, attr).data, rtol=1e-10)
    _assert_dicts_equal(ref.test_cf_treatment_seq.data_processed_seq,
                        ours.test_cf_treatment_seq.data_processed_seq,
                        rtol=1e-10)


def test_sequential_test_rows_carry_patient_types():
    """The n-step evaluation rows keep each row's patient type, as the JAX
    package's do (the port once dropped it)."""
    ours, ref = _collections('EQ_5_D')
    o, r = ours.test_cf_treatment_seq, ref.test_cf_treatment_seq
    scaling = ours.train_scaling_params
    process_data_tumor(o, scaling, 'multiclass', 'EQ_5_D', True)
    jax_process(r, scaling, 'multiclass', 'EQ_5_D', True)
    seq = o.process_sequential_test(PH)
    ref_seq = r.process_sequential_test(PH)
    assert 'patient_types' in seq
    np.testing.assert_array_equal(seq['patient_types'],
                                  o.data_original['patient_types'])
    _assert_dicts_equal(ref_seq, seq, rtol=1e-10)


@pytest.mark.parametrize('name', ['cancer_sim', 'EQ_5_C'])
def test_collection_from_numpy_matches_jax(name):
    """A JAX collection's raw subsets carried into the port's collection
    class of the family, then processed by both."""
    ref = jax_make_collection(name, SIZES, 4, 2.0, dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, name, projection_horizon=PH,
        treatment_mode='multiclass')
    assert isinstance(ours, CancerDatasetCollection)
    assert ours.equation_name == ref.equation_name
    continuous = name.startswith('EQ_5')
    ours.process_data_multi(include_continuous_treatment=continuous)
    ref.process_data_multi(include_continuous_treatment=continuous)
    for attr in SUBSETS:
        _assert_dicts_equal(getattr(ref, attr).data,
                            getattr(ours, attr).data)


def test_params_from_numpy_keeps_stage_names():
    params = cancer.generate_params(5, 2.0, 2.0, 15, 0,
                                    np.random.RandomState(0))
    out = convert.params_from_numpy(params, 'cpu', torch.float64)
    assert out['initial_stages'].dtype.kind == 'U'
    np.testing.assert_array_equal(out['initial_stages'],
                                  params['initial_stages'])
    assert out['alpha'].dtype == torch.float64
    assert out['window_size'] == 15 and isinstance(out['lag'], int)
