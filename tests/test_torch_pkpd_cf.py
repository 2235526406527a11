"""PKPD counterfactual test sets: the port's cores against the JAX cores on
the same parameters, treatment draws and plans (float64), its plan draws
and its collection's shared test patients, and the scaling parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.sim import pkpd as jp
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import make_collection
from insite_tpu_torch.sim import pkpd as tp

N, SEQ, PH = 12, 60, 5


def _params(seed=0):
    p = jp.generate_params(N, conf_coeff=2.0, window_size=15, lag=0,
                           key=jax.random.PRNGKey(seed),
                           equation=jp.Equation.EQ_4_D, dtype=jnp.float64)
    return {k: np.array(v) for k, v in p.items()}


def _both(params):
    return ({k: (jnp.asarray(v) if np.ndim(v) else v)
             for k, v in params.items()},
            convert.params_from_numpy(params, 'cpu', torch.float64))


def _assert_rows_match(ref, out):
    vol_r, act_r, len_r = (np.asarray(a) for a in ref)
    vol, act, lengths = (a.numpy() for a in out)
    assert vol.shape == vol_r.shape and act.shape == act_r.shape
    np.testing.assert_array_equal(lengths, len_r)
    np.testing.assert_array_equal(act, act_r)
    np.testing.assert_allclose(vol, vol_r, rtol=1e-12, atol=0)


def test_cf_1_step_core_matches_jax_f64():
    params = _params()
    jparams, tparams = _both(params)
    rvs = np.random.RandomState(1).rand(N)
    ref = jp._simulate_cf_1_step_core(jparams, jnp.asarray(rvs), SEQ,
                                      dtype=jnp.float64)
    out = tp._simulate_cf_1_step_core(tparams, torch.from_numpy(rvs), SEQ,
                                      dtype=torch.float64)
    _assert_rows_match(ref, out)
    act = out[1].numpy()
    assert act.shape == (N, 2 * (SEQ - 1), SEQ)
    # counterfactual row t flips the factual row's arm at its last step t
    t = np.arange(SEQ - 1)
    np.testing.assert_array_equal(act[:, 1::2][:, t, t],
                                  1 - act[:, 0::2][:, t, t])


@pytest.mark.parametrize('mode', tp.CF_SEQ_MODES)
def test_cf_seq_core_matches_jax_f64(mode):
    params = _params(1)
    jparams, tparams = _both(params)
    rng = np.random.RandomState(2)
    rvs = rng.rand(N)
    if mode == 'sliding_treatment':
        plans = tp.treatment_plans(N, SEQ, PH, mode, None, 'cpu').numpy()
    else:
        plans = rng.randint(0, 2, (N, SEQ - 1, 2 * PH, PH)).astype(np.int32)
    ref = jp._simulate_cf_seq_core(jparams, jnp.asarray(rvs),
                                   jnp.asarray(plans), SEQ, PH,
                                   dtype=jnp.float64)
    out = tp._simulate_cf_seq_core(tparams, torch.from_numpy(rvs),
                                   torch.from_numpy(plans), SEQ, PH,
                                   dtype=torch.float64)
    _assert_rows_match(ref, out)
    assert out[0].shape == (N, (SEQ - 1) * 2 * PH, SEQ + PH)


def test_random_trajectory_plans_are_fair_coins():
    gen = torch.Generator().manual_seed(0)
    plans = tp.treatment_plans(40, SEQ, PH, 'random_trajectories', gen,
                               'cpu')
    assert plans.shape == (40, SEQ - 1, 2 * PH, PH)
    assert plans.dtype == torch.int32
    assert set(plans.unique().tolist()) == {0, 1}
    share, n = plans.double().mean().item(), plans.numel()
    assert abs(share - 0.5) < 3 * np.sqrt(0.25 / n)
    with pytest.raises(ValueError):
        tp.treatment_plans(4, SEQ, PH, 'sliding', gen, 'cpu')


def test_scaling_params_match_jax():
    rng = np.random.RandomState(3)
    sim = {'cancer_volume': rng.rand(30, SEQ) * 50,
           'sequence_lengths': rng.randint(2, SEQ, 30),
           'observed_static_c_0': rng.rand(30),
           'observed_static_c_1': rng.rand(30)}
    assert tp.get_scaling_params(sim) == jp.get_scaling_params(sim)


def _arm_shifts(ds):
    p = ds.sim_params
    return (p['hidden_C_0'] - p['observed_static_c_0'],
            p['hidden_C_1'] - p['observed_static_c_1'])


def test_eq4d_shift_is_shared_by_every_subset():
    """EQ_4_D draws one decay-constant shift per arm for the whole
    population: the training and test cohorts, seeded alike but of other
    sizes, must share it (the JAX package's key splits do not depend on
    the cohort size)."""
    coll = make_collection('EQ_4_D', {'train': 50, 'val': 7, 'test': 3},
                           seed=2, coeff=2.0, device='cpu',
                           dtype=torch.float64)
    ref = np.array([s[0] for s in _arm_shifts(coll.train_f)])
    for ds in (coll.train_f, coll.val_f, coll.test_cf_one_step,
               coll.test_cf_treatment_seq):
        for arm, shift in enumerate(_arm_shifts(ds)):
            np.testing.assert_allclose(shift, ref[arm], rtol=0, atol=1e-15)


@pytest.mark.parametrize('mode', tp.CF_SEQ_MODES)
def test_collection_test_sets_share_their_patients(mode):
    coll = make_collection('EQ_4_A', {'train': 16, 'val': 4, 'test': 3},
                           seed=5, coeff=2.0, device='cpu',
                           dtype=torch.float64, cf_seq_mode=mode)
    one, seq = coll.test_cf_one_step, coll.test_cf_treatment_seq
    for k, v in one.sim_params.items():
        np.testing.assert_array_equal(v, seq.sim_params[k])
    rows_one, rows_seq = 2 * (SEQ - 1), 2 * PH * (SEQ - 1)
    assert len(one.data['cancer_volume']) == 3 * rows_one
    assert len(seq.data['cancer_volume']) == 3 * rows_seq
    # EQ_4_A has no observation noise: each patient's first factual row
    # (volumes[:2], its arm) opens every row block of both test sets
    first_one = one.data['cancer_volume'][::rows_one, :2]
    first_seq = seq.data['cancer_volume'][::rows_seq, :2]
    np.testing.assert_array_equal(first_one, first_seq)
    np.testing.assert_array_equal(
        one.data['treatment_application'][::rows_one, 0],
        seq.data['treatment_application'][::rows_seq, 0])
    assert np.isfinite(seq.data['cancer_volume']).all()
