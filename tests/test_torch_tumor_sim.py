"""Tumor-family simulators: the port's cores against the JAX cores on the
same parameters and draws, and its generators against the JAX package's at
equal seed (a ``np.random.RandomState`` here, the global ``np.random``
there), for cancer_sim and the four EQ_5 variants, in float64 on the CPU.

Tolerances: discrete arrays (applications, lengths, flags, validity) must
be equal; volumes, dosages and probabilities agree to rtol 1e-10 (the two
packages' log, exp and cube root may differ in the last ulp, and the
windowed diameter sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.sim import cancer as jc
from insite_tpu.sim import continuous as jcont
from insite_tpu.sim import tumor as jt
from insite_tpu.sim.pkpd import Equation as JaxEquation
from insite_tpu_torch import convert
from insite_tpu_torch.sim import cancer as tc
from insite_tpu_torch.sim import continuous as tcont
from insite_tpu_torch.sim import tumor as tt
from insite_tpu_torch.sim.pkpd import Equation

N, SEQ, PH, WINDOW = 16, 60, 5, 15
DISCRETE = ('chemo_application', 'radio_application', 'sequence_lengths',
            'death_flags', 'recovery_flags', 'active', 'patient_types',
            'initial_stages', 'patient_ids_all_trajectories',
            'patient_current_t')
RTOL = 1e-10


def _assert_same(ref: dict, out: dict):
    assert set(ref) == set(out)
    for k in ref:
        r = np.asarray(ref[k])
        o = out[k].cpu().numpy() if torch.is_tensor(out[k]) else \
            np.asarray(out[k])
        assert r.shape == o.shape, k
        if k in DISCRETE or r.dtype.kind not in 'f':
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=RTOL, atol=0, err_msg=k)


def _params(seed=0, n=N):
    rs = np.random.RandomState(seed)
    return tc.generate_params(n, 2.0, 2.0, WINDOW, 0, rs)


def _both_params(params):
    return (jc._device_params(params, jnp.float64),
            convert.params_from_numpy(params, 'cpu', torch.float64))


def _rvs(seed, n, T, noise_len):
    rs = np.random.RandomState(seed)
    return {'noise': 0.01 * rs.randn(n, noise_len),
            'recovery': rs.rand(n, T), 'chemo_rv': rs.rand(n, T),
            'radio_rv': rs.rand(n, T)}


def _both_rvs(rvs):
    return ({k: jnp.asarray(v) for k, v in rvs.items()},
            {k: torch.from_numpy(v) for k, v in rvs.items()})


def _stopping_params():
    """Standard parameters, with three patients starting near the death
    threshold and three at a volume whose recovery draw fires, so both
    early exits and their flags are exercised."""
    params = _params(1)
    params['initial_volumes'][:3] = 0.97 * jt.TUMOUR_DEATH_THRESHOLD
    params['initial_volumes'][3:6] = 1e-10
    return params


def test_factual_core_matches_jax_f64():
    params = _stopping_params()
    jp, tp = _both_params(params)
    jr, tr = _both_rvs(_rvs(2, N, SEQ, SEQ))
    ref = jt.factual_core(jp, jr, SEQ, WINDOW, 0)
    out = tt.factual_core(tp, tr, SEQ, WINDOW, 0)
    _assert_same(ref, out)
    assert out['death_flags'].sum() >= 1 and out['recovery_flags'].sum() >= 1
    assert (out['sequence_lengths'] < SEQ - 1).sum() >= 2
    assert out['chemo_application'].sum() > 0


@pytest.mark.parametrize('lag', [0, 2])
def test_cf_factual_core_matches_jax_f64(lag):
    params = _stopping_params()
    jp, tp = _both_params(params)
    jr, tr = _both_rvs(_rvs(3, N, SEQ, SEQ + PH))
    ref = jt.cf_factual_core(jp, jr, SEQ, WINDOW, lag)
    out = tt.cf_factual_core(tp, tr, SEQ, WINDOW, lag)
    _assert_same(ref, out)
    assert not out['active'].all() and out['active'].any()


def _cf_fact(seed, noise_len):
    params = _params(seed)
    jp, tp = _both_params(params)
    rvs = _rvs(seed + 10, N, SEQ, noise_len)
    jr, tr = _both_rvs(rvs)
    return (jp, tp, jr, tr, jt.cf_factual_core(jp, jr, SEQ, WINDOW, 0),
            tt.cf_factual_core(tp, tr, SEQ, WINDOW, 0))


def test_cf_one_step_rows_match_jax_f64():
    jp, tp, jr, tr, jf, tf = _cf_fact(4, SEQ)
    ref = jt.cf_one_step_rows(jp, jf, jr['noise'], SEQ)
    out = tt.cf_one_step_rows(tp, tf, tr['noise'], SEQ)
    names = ('volumes', 'chemo_application', 'radio_application',
             'sequence_lengths', 'active')
    _assert_same(dict(zip(names, ref)), dict(zip(names, out)))
    assert out[0].shape == (N, SEQ - 1, 4, SEQ)


@pytest.mark.parametrize('mode', tc.CF_SEQ_MODES)
def test_cf_seq_rows_match_jax_f64(mode):
    jp, tp, jr, tr, jf, tf = _cf_fact(5, SEQ + PH)
    plans = tc.treatment_plans(np.random.RandomState(6), N, SEQ, PH, mode)
    ref = jt.cf_seq_rows(jp, jf, jnp.asarray(plans, jnp.float64),
                         jr['noise'], SEQ, PH)
    out = tt.cf_seq_rows(tp, tf, torch.as_tensor(np.ascontiguousarray(plans)),
                         tr['noise'], SEQ, PH)
    names = ('volumes', 'chemo_application', 'radio_application',
             'chemo_dosage', 'sequence_lengths', 'active')
    _assert_same(dict(zip(names, ref)), dict(zip(names, out)))
    assert out[0].shape == (N, SEQ - 1, 2 * PH, SEQ + PH)


def test_cf_seq_rows_drop_matches_jax():
    """The NaN and negative-mid-plan drop: an extreme-alpha patient whose
    radio step sends the volume below zero loses every row; a normal
    patient keeps its rows."""
    T, ph, n = 12, 3, 2
    params = {
        'initial_volumes': np.array([300.0, 300.0]),
        'alpha': np.array([0.03, 2.0]), 'beta': np.array([0.003, 0.2]),
        'beta_c': np.full(n, 0.028), 'rho': np.full(n, 7e-3),
        'K': np.full(n, jt.calc_volume(30.0)),
        'chemo_sigmoid_intercepts': np.full(n, 6.5),
        'radio_sigmoid_intercepts': np.full(n, 6.5),
        'chemo_sigmoid_betas': np.full(n, 0.1),
        'radio_sigmoid_betas': np.full(n, 0.1)}
    jp, tp = _both_params(params)
    rvs = {'noise': np.zeros((n, T + ph)), 'recovery': np.ones((n, T)),
           'chemo_rv': np.full((n, T), 2.0), 'radio_rv': np.full((n, T), 2.0)}
    jr, tr = _both_rvs(rvs)
    plans = np.zeros((n, T - 1, 2, ph, 2))
    plans[:, :, 0, 0, 1] = 1.0       # plan 0: radio at the first step
    jf = jt.cf_factual_core(jp, jr, T, WINDOW, 0)
    tf = tt.cf_factual_core(tp, tr, T, WINDOW, 0)
    ref = jt.cf_seq_rows(jp, jf, jnp.asarray(plans), jr['noise'], T, ph)
    out = tt.cf_seq_rows(tp, tf, torch.from_numpy(plans), tr['noise'], T, ph)
    np.testing.assert_array_equal(out[-1].numpy(), np.asarray(ref[-1]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=RTOL)
    valid = out[-1].numpy()
    assert valid[0].all()                     # the normal patient
    assert not valid[1, :, 0].any()           # the radio plan: dropped
    assert valid[1, :, 1].all()               # no treatment: kept
    assert (out[0][1, :, 0] < -1e-7).any()


def _jax_variant(name):
    if name == 'cancer_sim':
        return (jc.generate_params, jc.simulate_factual,
                jc.simulate_counterfactual_1_step,
                jc.simulate_counterfactuals_treatment_seq)
    eq = JaxEquation[name]
    return (lambda *a, **k: jcont.generate_params(*a, equation=eq, **k),
            lambda *a, **k: jcont.simulate_factual(*a, equation=eq, **k),
            lambda *a, **k: jcont.simulate_counterfactual_1_step(
                *a, equation=eq, **k),
            lambda *a, **k: jcont.simulate_counterfactuals_treatment_seq(
                *a, equation=eq, **k))


def _port_variant(name):
    if name == 'cancer_sim':
        return (tc.generate_params, tc.simulate_factual,
                tc.simulate_counterfactual_1_step,
                tc.simulate_counterfactuals_treatment_seq)
    eq = Equation[name]
    return (lambda *a, **k: tcont.generate_params(*a, equation=eq, **k),
            lambda *a, **k: tcont.simulate_factual(*a, equation=eq, **k),
            lambda *a, **k: tcont.simulate_counterfactual_1_step(
                *a, equation=eq, **k),
            lambda *a, **k: tcont.simulate_counterfactuals_treatment_seq(
                *a, equation=eq, **k))


@pytest.mark.parametrize('mode', tc.CF_SEQ_MODES)
@pytest.mark.parametrize('name', ['cancer_sim', 'EQ_5_A', 'EQ_5_B',
                                  'EQ_5_C', 'EQ_5_D'])
def test_generators_draw_the_jax_cohort(name, mode):
    """Parameters, factual cohort and both counterfactual sets, drawn one
    after the other from one stream seeded alike."""
    n, seed = 9, 7
    j_gen, j_fact, j_one, j_seq = _jax_variant(name)
    t_gen, t_fact, t_one, t_seq = _port_variant(name)
    np.random.seed(seed)
    ref = []
    for sim in ('fact', 'one', 'seq'):
        p = j_gen(n, 2.0, 2.0, WINDOW, 0)
        ref.append(p)
        if sim == 'fact':
            ref.append(j_fact(p, SEQ, dtype=jnp.float64))
        elif sim == 'one':
            ref.append(j_one(p, SEQ, dtype=jnp.float64))
        else:
            ref.append(j_seq(p, SEQ, PH, cf_seq_mode=mode,
                             dtype=jnp.float64))
    rs = np.random.RandomState(seed)
    kw = dict(device='cpu', dtype=torch.float64)
    out = []
    for sim in ('fact', 'one', 'seq'):
        p = t_gen(n, 2.0, 2.0, WINDOW, 0, rs)
        out.append(p)
        if sim == 'fact':
            out.append(t_fact(p, SEQ, rs, **kw))
        elif sim == 'one':
            out.append(t_one(p, SEQ, rs, **kw))
        else:
            out.append(t_seq(p, SEQ, PH, rs, cf_seq_mode=mode, **kw))
    for r, o in zip(ref, out):
        _assert_same(r, o)
    # what draws there are: the patient types of the variant, the dosage
    # rows of EQ_5's counterfactual sets
    types = set(out[0]['patient_types'])
    assert types <= ({1} if name in ('EQ_5_A', 'EQ_5_B') else {1, 2, 3})
    assert ('chemo_dosage' in out[3]) == name.startswith('EQ_5')
    assert rs.rand() == np.random.rand()      # the streams end alike


def test_scaling_params_match_jax():
    rs = np.random.RandomState(3)
    sim = {'cancer_volume': rs.rand(30, SEQ) * 500,
           'chemo_dosage': rs.rand(30, SEQ) * 5,
           'radio_dosage': rs.rand(30, SEQ) * 2,
           'sequence_lengths': rs.randint(2, SEQ, 30),
           'patient_types': rs.randint(1, 4, 30)}
    assert tc.get_scaling_params(sim) == jc.get_scaling_params(sim)


def test_unknown_cf_seq_mode_raises():
    with pytest.raises(ValueError, match='cf_seq_mode'):
        tc.treatment_plans(np.random.RandomState(0), 2, SEQ, PH, 'sliding')
