"""The tuners (`harness/tuning.py`) against the JAX package's: the same
grids and trials, the INSITE lam grid scored by one stacked fine-tune equal
to the JAX package's vmapped one in float64 on the CPU (scores rtol 1e-6;
measured ~1e-10), the per-row penalty equal to the scalar path bit for
bit, the neural searches' selection rules, and a tiny ct `--tune` row.

Cohorts come from the JAX package (`convert.collection_from_numpy`), so
both packages tune the same fitted model on the same validation rows."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.harness import tuning as jax_tuning
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.harness import runner, tuning
from insite_tpu_torch.harness.config import RunConfig, model_dataset_name
from insite_tpu_torch.models.sindy import (SINDyConfig, SINDyRegressor,
                                           insite_gn_finetune_predict,
                                           support)
from insite_tpu_torch.ops import rollout

F64 = dict(device='cpu', dtype=torch.float64)
SIZES = {'train': 60, 'val': 8, 'test': 2}
torch.set_num_threads(1)

NEURAL = ('ct', 'crn', 'edct', 'rmsn', 'gnet')


def test_grids_are_the_jax_packages():
    assert tuning.INSITE_LAM_GRID == jax_tuning.INSITE_LAM_GRID
    assert tuning.NEURAL_HPARAM_GRIDS == jax_tuning.NEURAL_HPARAM_GRIDS


@pytest.mark.parametrize('method', NEURAL)
def test_grid_points_equal_jax(method):
    """The full grid, and the seeded subsample of every trial count the
    sweep may ask for, are the JAX package's lists."""
    space = tuning.NEURAL_HPARAM_GRIDS[method]
    assert tuning.grid_points(space) == jax_tuning.grid_points(space)
    for n_trials, seed in ((1, 0), (2, 3), (10, 0), (16, 7)):
        got = tuning.grid_points(space, n_trials, seed)
        assert got == jax_tuning.grid_points(space, n_trials, seed)
        assert len(got) == n_trials
    small = {'a': [1, 2, 3], 'b': [10, 20]}
    assert tuning.grid_points(small, n_trials=9) == \
        jax_tuning.grid_points(small) == tuning.grid_points(small)


@pytest.mark.parametrize('method', NEURAL)
def test_neural_grid_keys_are_config_fields(method):
    """Every key of a method's grid is a field of the port's config for
    that method, so a trial's params reach the model as overrides."""
    import dataclasses
    _, cfg_cls = runner.NEURAL_MODELS[method]
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    assert set(tuning.NEURAL_HPARAM_GRIDS[method]) <= fields


def _fitted_pair(name, **extra):
    """(the port's INSITE model, its validation set, the JAX model, its
    validation set), fitted on one JAX cohort in float64."""
    mode = 'multilabel' if extra.get('joint_model') else 'multiclass'
    ref = jax_make_collection(name, SIZES, 0, 2.0, treatment_mode=mode,
                              dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, name, projection_horizon=5,
        treatment_mode=mode)
    cont = 'EQ_5' in name
    ref.process_data_multi(include_continuous_treatment=cont)
    ours.process_data_multi(include_continuous_treatment=cont)
    cfg = dict(dataset_name=model_dataset_name(name), insite=True,
               treatment_mode=mode, **extra)
    model = SINDyRegressor(SINDyConfig(**cfg), ours, **F64).fit(ours.train_f)
    jax_model = JaxRegressor(JaxConfig(**cfg), ref).fit(ref.train_f)
    return model, ours.val_f, jax_model, ref.val_f


@pytest.mark.parametrize('name,extra', [
    ('EQ_4_D', {}), ('EQ_4_D', dict(smooth_input_data=True)),
    ('EQ_4_D', dict(joint_model=True)), ('cancer_sim', {}),
    ('EQ_4_D', dict(sindy_threshold=100.0))],
    ids=['eq4d', 'eq4d-smooth', 'eq4d-one-ode', 'cancer_sim',
         'empty-support'])
def test_tune_insite_lam_matches_jax(name, extra):
    """The seven scores equal the JAX tuner's at rtol 1e-6, with the same
    best lam, which both set as the model's lam. With an empty support
    every lam scores the same and the first wins."""
    model, val_f, jax_model, jax_val_f = _fitted_pair(name, **extra)
    best, scores = tuning.tune_insite_lam(model, val_f)
    jax_best, jax_scores = jax_tuning.tune_insite_lam(jax_model, jax_val_f)
    assert list(scores) == list(jax_scores) == list(tuning.INSITE_LAM_GRID)
    np.testing.assert_allclose([scores[k] for k in scores],
                               [jax_scores[k] for k in scores], rtol=1e-6)
    assert best == jax_best == model.cfg.lam == jax_model.cfg.lam
    assert all(np.isfinite(v) for v in scores.values())
    if 'sindy_threshold' in extra:
        assert not support(model.coefs)
        assert len(set(scores.values())) == 1 and best == 0.0


def test_one_tune_is_one_fine_tune(monkeypatch):
    """A tuning call is one fine-tune over 7 x n_val rows: gn_iters + 1 =
    13 sensitivity calls and one rollout, here of the kernels' plain
    versions (the tensors are on the CPU)."""
    model, val_f, _, _ = _fitted_pair('EQ_4_D')
    calls = {'rollout': [], 'sens': []}
    plain_roll = rollout.batched_rollout_plain
    plain_sens = rollout.rollout_with_sens_plain

    def roll(*args, **kwargs):
        calls['rollout'].append(args[1].shape[0])
        return plain_roll(*args, **kwargs)

    def sens(*args, **kwargs):
        calls['sens'].append(args[1].shape[0])
        return plain_sens(*args, **kwargs)

    monkeypatch.setattr(rollout, 'batched_rollout_plain', roll)
    monkeypatch.setattr(rollout, 'rollout_with_sens_plain', sens)
    tuning.tune_insite_lam(model, val_f)
    rows = 7 * SIZES['val']
    assert calls == {'rollout': [rows], 'sens': [rows] * 13}


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_per_row_lam_of_equal_values_is_the_scalar_path(dtype):
    """A [B] penalty of equal values gives the scalar path's predictions
    and coefficients bit for bit; a [B] penalty of the grid gives each
    block the result of a scalar call with its value."""
    model, val_f, _, _ = _fitted_pair('EQ_4_D')
    prev, statics, arms, lengths = (x.to(dtype) if x.is_floating_point()
                                    else x
                                    for x in model._rollout_args(val_f))
    kw = dict(projection_horizon=1, gn_iters=12,
              active_idx=support(model.coefs))
    coefs = torch.as_tensor(model.coefs, dtype=dtype)
    args = (model.library, coefs, prev, statics, arms, lengths, model.dt)
    p_s, c_s = insite_gn_finetune_predict(*args, lam=10.0, **kw)
    lam = torch.full((prev.shape[0],), 10.0, dtype=torch.float64)
    p_t, c_t = insite_gn_finetune_predict(*args, lam=lam, **kw)
    assert torch.equal(p_s, p_t) and torch.equal(c_s, c_t)
    grid = (0.0, 1000.0)
    stacked = [x.repeat(2, *[1] * (x.ndim - 1)) for x in args[2:6]]
    lam = torch.tensor(grid, dtype=torch.float64).repeat_interleave(
        prev.shape[0])
    p_g, _ = insite_gn_finetune_predict(*args[:2], *stacked, model.dt,
                                        lam=lam, **kw)
    for g, value in enumerate(grid):
        p_one, _ = insite_gn_finetune_predict(*args, lam=value, **kw)
        torch.testing.assert_close(p_g[g * len(prev):(g + 1) * len(prev)],
                                   p_one, rtol=1e-5, atol=0)


def test_successive_halving_search_promotes_survivors():
    """The adaptive tuner spends most budget on configs that win early
    rungs, and the returned model is trained at the full budget."""
    fitted = []

    class _Stub:
        def __init__(self, params):
            self.params = params

        def get_normalised_masked_rmse(self, val_f):
            # config quality = |x - 3|; more epochs always helps a bit
            p = self.params
            return 0.0, abs(p['x'] - 3) + 10.0 / p['epochs']

    def build_and_fit(params):
        fitted.append(dict(params))
        return _Stub(params)

    best, model, trials = tuning.successive_halving_search(
        build_and_fit, {'x': [0, 1, 2, 3, 4, 5]}, val_f=None, n_trials=6,
        eta=3, min_budget=4, max_budget=36)
    assert best == {'x': 3}
    assert model.params['epochs'] == 36      # winner refit at full budget
    assert sorted({f['epochs'] for f in fitted}) == [4, 12, 36]
    budgets = [f['epochs'] for f in fitted]
    assert (budgets.count(4), budgets.count(12), budgets.count(36)) == \
        (6, 2, 1)
    assert [t['rung'] for t in trials] == [0] * 6 + [1] * 2 + [2]


@pytest.mark.parametrize('search', ['grid', 'sha'])
def test_search_whose_every_trial_errors_raises(search):
    """Each trial is tried ``max_failures`` times, then recorded as
    errored; a search with no trial left raises."""
    attempts = []

    def build_and_fit(params):
        attempts.append(params)
        raise FloatingPointError('diverged')

    space = {'x': [1, 2]}
    with pytest.raises(RuntimeError, match='errored'):
        if search == 'grid':
            tuning.grid_search(build_and_fit, space, None, max_failures=2)
        else:
            tuning.successive_halving_search(build_and_fit, space, None,
                                             n_trials=2, max_failures=2)
    assert len(attempts) == 4


def test_ct_tune_end_to_end(monkeypatch, tmp_path):
    """`--tune` for a neural method: two trials of a seeded grid, the
    winner's hparams first in the row, as in the JAX package's row, and
    used for the test metrics."""
    monkeypatch.setitem(tuning.NEURAL_HPARAM_GRIDS, 'ct',
                        {'learning_rate': [0.01, 0.001],
                         'dropout_rate': [0.1]})
    cfg = RunConfig(train_samples=24, val_samples=8, test_samples=4,
                    epochs=1, tune_hparams=True, tune_trials=2,
                    metrics_jsonl=str(tmp_path / 'metrics.jsonl'))
    r = runner.run_experiment('EQ_4_D', 'ct', seed=0, domain_conf=2.0,
                              cfg=cfg, device='cpu')
    assert list(r)[:2] == ['tuned_hparams', 'encoder_test_rmse_all']
    assert r['tuned_hparams']['learning_rate'] in (0.01, 0.001)
    assert r['tuned_hparams']['dropout_rate'] == 0.1
    assert np.isfinite(r['encoder_test_rmse_orig'])
    assert runner._plain(r) == r
