"""The joint (one-ODE) model: multilabel processing, the fold of the joint
library onto the per-arm rollouts (`ops/joint_fold.py`), and the joint
A-SINDy / INSITE estimator, against the JAX package in float64 on the CPU.

Tolerances: processing is numpy in both packages, so its arrays are equal;
the fold against the plain joint rollout and against the JAX joint rollout
is the same Euler arithmetic with the monomials grouped differently, rtol
1e-12; folded sensitivities against `jax.jacfwd` through the JAX joint
rollout, rtol 1e-9 (as the per-arm recurrence); the estimator's
coefficients agree to rtol 1e-8 with equal equation strings, A-SINDy RMSEs
to rtol 1e-10 and INSITE RMSEs to rtol 1e-8 (the same LM sequence, with the
Jacobian from the folded recurrence here and jvp there)."""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.discovery import wsindy as jax_wsindy
from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.runner import Experiment as JaxExperiment
from insite_tpu.harness.runner import sweep as jax_sweep
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu.models.sindy import batched_rollout as jax_rollout
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.discovery import wsindy
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig, model_dataset_name
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
from insite_tpu_torch.ops import rollout
from insite_tpu_torch.ops.joint_fold import JointFold, combination_index

F64 = dict(device='cpu', dtype=torch.float64)
SIZES = {'train': 40, 'val': 4, 'test': 2}
TINY = dict(train_samples=40, val_samples=4, test_samples=2)
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def pristine():
    """Unprocessed multilabel JAX collections."""
    return {name: jax_make_collection(name, SIZES, 0, 2.0,
                                      treatment_mode='multilabel')
            for name in ('EQ_4_D', 'cancer_sim', 'EQ_5_C')}


def _pair(pristine, name):
    """(the port's collection, the JAX one) over one unprocessed cohort."""
    ref = copy.deepcopy(pristine[name])
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, name, projection_horizon=5,
        treatment_mode='multilabel')
    return ours, ref


@pytest.mark.parametrize('name', ['EQ_4_D', 'cancer_sim', 'EQ_5_C'])
def test_multilabel_processing_equals_jax(pristine, name):
    ours, ref = _pair(pristine, name)
    continuous = 'EQ_5' in name
    ours.process_data_multi(include_continuous_treatment=continuous)
    ref.process_data_multi(include_continuous_treatment=continuous)
    width = 1 if name == 'EQ_4_D' else 2
    for subset in SUBSETS:
        got, want = getattr(ours, subset), getattr(ref, subset)
        assert set(got.data) == set(want.data)
        for k in want.data:
            np.testing.assert_array_equal(got.data[k],
                                          np.asarray(want.data[k]),
                                          err_msg=f'{subset} {k}')
        for k in want.scaling_params:
            np.testing.assert_array_equal(got.scaling_params[k],
                                          want.scaling_params[k])
        treatments = got.data['current_treatments']
        assert treatments.shape[-1] == width
        assert set(np.unique(treatments)) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# the fold

def _joint_case(E, S, seed, B=7, T=9, degree_kw=None):
    """A joint model over [y, E binary treatment inputs, S statics]:
    decay on y plus small terms on every feature."""
    rs = np.random.RandomState(seed)
    spec = dict(n_inputs=1 + E + S, **(degree_kw or {}))
    F = PolynomialLibrary(**spec).n_features
    coefs = 0.05 * rs.randn(B, 1, F)
    coefs[:, 0, 1] -= 0.8                          # feature 1 is y
    treatments = rs.randint(0, 2, (B, T, E)).astype(np.float64)
    return dict(spec=spec, coefs=coefs, y0=rs.rand(B) * 5 + 1,
                statics=rs.rand(B, S), treatments=treatments, dt=1 / 6, E=E)


CASES = {'eq4_one_input': lambda: _joint_case(1, 2, 0),
         'tumor_two_inputs': lambda: _joint_case(2, 1, 1),
         'eq5_two_inputs': lambda: _joint_case(2, 2, 2),
         'degree3_full': lambda: _joint_case(
             2, 1, 3, degree_kw=dict(degree=3, interaction_only=False))}
CLIP = (0.5, 4.0)


def _fold_args(case):
    lib = PolynomialLibrary(**case['spec'])
    fold = JointFold(lib, case['E'])
    arms = torch.as_tensor(combination_index(case['treatments']))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    return lib, fold, (t(case['coefs']), t(case['y0']), t(case['statics']),
                       arms, case['dt'])


def _plain_joint_args(case):
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    B, T = case['treatments'].shape[:2]
    return (t(case['coefs']), t(case['y0']), t(case['statics']),
            torch.zeros(B, T, dtype=torch.int32), case['dt'])


def test_fold_matrices_of_the_tumor_library():
    fold = JointFold(PolynomialLibrary(n_inputs=4), 2)
    assert fold.M.shape == (4, 4, 11) and fold.library.n_inputs == 2
    # no treatment on: only the 4 features free of u0, u1 survive
    assert fold.M[0].sum() == 4
    # both on: every joint feature lands on its reduced feature
    assert fold.M[3].sum() == 11 and (fold.M[3].sum(0) == 1).all()
    assert JointFold(PolynomialLibrary(n_inputs=5), 2).M.shape == (4, 7, 16)
    assert JointFold(PolynomialLibrary(n_inputs=4), 1).M.shape == (2, 7, 11)


@pytest.mark.parametrize('clip', [None, CLIP], ids=['free', 'clip'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_folded_rollout_matches_plain_joint_and_jax(name, clip):
    case = CASES[name]()
    lib, fold, args = _fold_args(case)
    got = fold.rollout(*args, y_clip=clip).numpy()
    plain = rollout.batched_rollout_plain(
        lib, *_plain_joint_args(case), y_clip=clip,
        treatments=torch.as_tensor(case['treatments'])).numpy()
    ref = np.asarray(jax_rollout(
        JaxLibrary(**case['spec']), jnp.asarray(case['coefs']),
        jnp.asarray(case['y0']), jnp.asarray(case['statics']),
        jnp.asarray(case['treatments']), case['dt'], joint=True,
        y_clip=clip))
    np.testing.assert_allclose(got, plain, rtol=1e-12)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    if clip is not None:
        assert (got == clip[0]).any() or (got == clip[1]).any()


@pytest.mark.parametrize('clip', [None, CLIP], ids=['free', 'clip'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_folded_sensitivities_match_plain_joint_and_jacfwd(name, clip):
    case = CASES[name]()
    lib, fold, args = _fold_args(case)
    F = lib.n_features
    active = tuple(range(0, F, 2)) + (1,)          # a subset, unordered
    y, s = fold.rollout_with_sens(*args, active, y_clip=clip)
    y_p, s_p = rollout.rollout_with_sens_plain(
        lib, *_plain_joint_args(case), active, y_clip=clip,
        treatments=torch.as_tensor(case['treatments']))
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), rtol=1e-12)
    np.testing.assert_allclose(s.numpy(), s_p.numpy(), rtol=1e-9,
                               atol=1e-13)
    assert s.shape == (7, 9, len(active))
    eff_idx, M_act = fold.effective_active(active)
    assert M_act.shape == (len(eff_idx), len(active))
    assert len(eff_idx) <= fold.n_arms * fold.library.n_features

    act = np.asarray(active)
    jl = JaxLibrary(**case['spec'])

    def roll_row(c_act, c_row, y0, statics, treatments):
        c = c_row.at[0, act].set(c_act)
        return jax_rollout(jl, c[None], y0[None], statics[None],
                           treatments[None], case['dt'], joint=True,
                           y_clip=clip)[0]

    coefs = jnp.asarray(case['coefs'])
    ref = jax.vmap(jax.jacfwd(roll_row))(
        coefs[:, 0, act], coefs, jnp.asarray(case['y0']),
        jnp.asarray(case['statics']), jnp.asarray(case['treatments']))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-13)


def test_eq4_single_column_treatments_fold_like_a_trailing_axis():
    treatments = np.random.RandomState(0).randint(0, 2, (5, 8))
    np.testing.assert_array_equal(combination_index(treatments), treatments)
    np.testing.assert_array_equal(
        combination_index(np.stack([treatments, 1 - treatments], -1)),
        treatments + 2 * (1 - treatments))
    assert combination_index(treatments).dtype == np.int32


def test_fold_refuses_non_binary_treatments():
    with pytest.raises(ValueError, match='binary'):
        combination_index(np.array([[0.0, 0.5]]))
    with pytest.raises(ValueError, match='binary'):
        combination_index(np.array([[[0, 1], [2, 0]]]))


# ---------------------------------------------------------------------------
# the estimator

def _evaluate(model, coll):
    model.fit(coll.train_f)
    return (np.asarray(model.coefs), model.global_equation_string,
            model.get_normalised_masked_rmse(coll.test_cf_one_step,
                                             one_step_counterfactual=True),
            np.asarray(model.get_normalised_n_step_rmses(
                coll.test_cf_treatment_seq)))


@pytest.mark.parametrize('insite', [False, True], ids=['sindy', 'insite'])
@pytest.mark.parametrize('name', ['EQ_4_D', 'cancer_sim'])
def test_joint_regressor_matches_jax_f64(pristine, name, insite):
    ours, ref = _pair(pristine, name)
    cfg = dict(dataset_name=model_dataset_name(name),
               sindy_threshold=0.1 if name == 'EQ_4_D' else 0.001,
               insite=insite, joint_model=True, treatment_mode='multilabel')
    model = SINDyRegressor(SINDyConfig(**cfg), ours, **F64)
    c, eq, one, n_step = _evaluate(model, ours)
    c_r, eq_r, one_r, n_step_r = _evaluate(
        JaxRegressor(JaxConfig(**cfg), ref), ref)
    np.testing.assert_allclose(c, c_r, rtol=1e-8, atol=1e-14)
    assert eq == eq_r and eq.startswith('Joint Model: x_dot = ')
    assert c.shape == (1, 11)
    assert model._fold.n_arms == (2 if name == 'EQ_4_D' else 4)
    rtol = 1e-8 if insite else 1e-10
    np.testing.assert_allclose(one, one_r, rtol=rtol)
    np.testing.assert_allclose(n_step, n_step_r, rtol=rtol)


def test_eq4_joint_fits_in_multiclass_mode_too(pristine):
    """EQ_4's arm index is its one binary column in either mode."""
    ours, _ = _pair(pristine, 'EQ_4_D')
    multiclass = convert.collection_from_numpy(
        {k: copy.deepcopy(getattr(pristine['EQ_4_D'], k).data)
         for k in SUBSETS}, pristine['EQ_4_D'].train_scaling_params,
        'EQ_4_D', projection_horizon=5, treatment_mode='multiclass')
    out = []
    for coll, mode in ((ours, 'multilabel'), (multiclass, 'multiclass')):
        cfg = SINDyConfig(dataset_name='EQ_4_D', joint_model=True,
                          treatment_mode=mode)
        out.append(_evaluate(SINDyRegressor(cfg, coll, **F64), coll))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][3], out[1][3])


def test_tumor_joint_needs_multilabel(pristine):
    coll = convert.collection_from_numpy(
        {k: copy.deepcopy(getattr(pristine['cancer_sim'], k).data)
         for k in SUBSETS}, pristine['cancer_sim'].train_scaling_params,
        'cancer_sim', projection_horizon=5, treatment_mode='multiclass')
    cfg = SINDyConfig(dataset_name='CANCER_SIM', joint_model=True,
                      treatment_mode='multiclass', sindy_threshold=0.001)
    with pytest.raises(ValueError, match='multilabel'):
        SINDyRegressor(cfg, coll, **F64).fit(coll.train_f)


# ---------------------------------------------------------------------------
# wsindy x one ODE

def test_wsindy_one_ode_on_the_tumor_family_is_an_errored_row():
    """Both packages refuse the weak joint fit on the tumor family (the
    JAX package by an assert, the port by a named ValueError), and both
    sweeps turn that into an errored row."""
    kw = dict(methods=('wsindy',), datasets=('cancer_sim',), seed_runs=1,
              debug_mode=False, **TINY)
    rows, _ = runner.sweep(RunConfig(**kw),
                           runner.Experiment.ABLATION_ONE_ODE, device='cpu',
                           dtype=torch.float64)
    rows_r, _ = jax_sweep(JaxRunConfig(metrics_jsonl='', **kw),
                          JaxExperiment.ABLATION_ONE_ODE)
    assert [r['errored'] for r in rows] == [True]
    assert [bool(r['errored']) for r in rows_r.to_dict('records')] == [True]
    with pytest.raises(ValueError, match='EQ_4 only'):
        runner.run_experiment('cancer_sim', 'wsindy', 0, 2.0,
                              RunConfig(**TINY),
                              runner.Experiment.ABLATION_ONE_ODE,
                              device='cpu', dtype=torch.float64)


def test_wsindy_one_ode_on_eq4_equals_jax(pristine):
    """On EQ_4 the JAX estimator hands `weak_system` the statics alone, one
    input short of its joint library [y, arm, statics]; its library reads
    the missing last input as the one before it, so the weak integrand sees
    [y, c0, c1, c1] and the arm never enters. The port mirrors the cell:
    the same coefficients (rtol 1e-8), equation string and RMSEs (rtol
    1e-8). The model is a poor one (its 1-step RMSE is several times the
    strong-form joint fit's), which the last line pins: when the reference
    is repaired, this test says so."""
    ours, ref = _pair(pristine, 'EQ_4_D')
    cfg = dict(dataset_name='EQ_4_D', wsindy=True, joint_model=True,
               treatment_mode='multilabel')
    model = SINDyRegressor(SINDyConfig(**cfg), ours, **F64)
    c, eq, one, n_step = _evaluate(model, ours)
    c_r, eq_r, one_r, n_step_r = _evaluate(
        JaxRegressor(JaxConfig(**cfg), ref), ref)
    assert c.shape == (1, 11) and eq.startswith('Joint Model: x_dot = ')
    np.testing.assert_allclose(c, c_r, rtol=1e-8, atol=1e-14)
    # the weak solves agree to ~1e-16 relative, not bit for bit: the strings
    # are compared with every number at 8 significant digits
    def rounded(equation):
        return re.sub(r'\d+\.\d+(e-?\d+)?',
                      lambda m: f'{float(m.group()):.8g}', equation)
    assert rounded(eq) == rounded(eq_r)
    np.testing.assert_allclose(one, one_r, rtol=1e-8)
    np.testing.assert_allclose(n_step, n_step_r, rtol=1e-8)

    # the weak system the port solves is the JAX one over [c0, c1, c1]
    prev, statics, _, lengths = model._unscaled_arrays(ours.train_f)
    volumes = np.concatenate(
        [prev[:, :1], np.squeeze(ours.train_f.data['unscaled_outputs'], -1)],
        axis=1)
    inputs = np.concatenate([statics, statics[:, -1:]], axis=1)
    eff_len = np.maximum(lengths - 1, 2)
    got = wsindy.weak_system(torch.as_tensor(volumes),
                             torch.as_tensor(inputs),
                             torch.as_tensor(eff_len), model.library,
                             model.dt)
    want = jax_wsindy.weak_system(jnp.asarray(volumes), jnp.asarray(statics),
                                  jnp.asarray(eff_len), JaxLibrary(4),
                                  model.dt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13)
    strong = _evaluate(SINDyRegressor(SINDyConfig(**dict(cfg, wsindy=False)),
                                      ours, **F64), ours)
    assert one[0] > 3 * strong[2][0]
