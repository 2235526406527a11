"""The sweep harness: the port's run rows against the JAX package's, a CPU
sweep through `python -m insite_tpu_torch.run` whose log the JAX parser
reads, the LaTeX main table against the JAX package's text, msm rows and
tiny INSIGHT sweeps against the JAX package's on handed-over cohorts (msm
RMSEs equal to rtol 1e-12, sindy RMSEs to rtol 1e-8), the sweep harness's
settings served, a method the JAX package lacks raising, and the neural
baselines served."""

import ast
import copy
import dataclasses
import json
import logging
import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.results import df_from_log
from insite_tpu.harness.results import \
    generate_main_results_table as jax_table
from insite_tpu.harness.runner import Experiment as JaxExperiment
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu.harness.runner import sweep as jax_sweep
from insite_tpu_torch import convert, run
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.harness import runner, tuning
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.results import (ci, custom_format,
                                              generate_main_results_table,
                                              rows_from_log)

TINY = dict(train_samples=40, val_samples=4, test_samples=2)
F64 = dict(device='cpu', dtype=torch.float64)
# the plain rollouts are thousands of small ops: intra-op threads only add
# synchronisation, and across parallel test workers they oversubscribe the
# cores (an order of magnitude slower on an 8-core host)
torch.set_num_threads(1)


@pytest.mark.parametrize('method', ['sindy', 'insite'])
def test_run_experiment_row_keys_match_jax(method):
    ref = jax_run_experiment('EQ_4_A', method, seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', **TINY))
    ours = runner.run_experiment('EQ_4_A', method, seed=0, domain_conf=2.0,
                                 cfg=RunConfig(**TINY), device='cpu',
                                 dtype=torch.float64)
    assert list(ours) == list(ref)
    assert ours['fine_tuned'] is (method == 'insite')
    assert all(isinstance(v, (bool, int, float, str)) for v in ours.values())


def test_cli_sweep_log_reads_back_in_both_packages(tmp_path):
    log_path = run.main(['--device', 'cpu', '--flush', '--datasets',
                         'EQ_4_D', '--methods', 'sindy', 'insite',
                         '--log-dir', str(tmp_path)])
    rows = rows_from_log(log_path)
    ref = df_from_log(log_path).to_dict('records')
    assert rows == ref
    assert [r['method_name'] for r in rows] == ['sindy', 'insite']
    for r in rows:
        assert r['errored'] is False and r['dataset_name'] == 'EQ_4_D'
        assert np.isfinite([r['encoder_test_rmse_orig'],
                            r['decoder_test_rmse_6-step']]).all()
    assert rows[1]['encoder_test_rmse_orig'] < \
        rows[0]['encoder_test_rmse_orig']
    text = open(log_path).read()
    assert 'Latex Table:: encoder_test_rmse_orig' in text
    assert '[Sweep config]' in text


def _table_rows(n_seeds):
    rng = np.random.RandomState(n_seeds)
    rows = []
    for seed in range(n_seeds):
        for ds in ('EQ_4_D', 'EQ_4_A'):
            for m in ('insite', 'sindy', 'msm'):
                row = {f'encoder_test_rmse_{k}': float(rng.rand())
                       for k in ('all', 'orig', 'last')}
                row.update({f'decoder_test_rmse_{k}-step':
                            float(rng.rand() * 10 ** -rng.randint(0, 4))
                            for k in range(2, 7)})
                row.update(method=m, seed=seed, errored=False,
                           dataset_name=ds, method_name=m, domain_conf=2.0)
                rows.append(row)
    rows[1]['decoder_test_rmse_3-step'] = 0.0
    rows.append({'errored': True, 'dataset_name': 'EQ_4_B', 'seed': 0,
                 'method_name': 'sindy', 'domain_conf': 2.0})
    return rows


@pytest.mark.parametrize('n_seeds', [1, 3])
def test_main_table_text_matches_jax(n_seeds):
    rows = _table_rows(n_seeds)
    ours = generate_main_results_table(rows)
    assert ours == jax_table(pd.DataFrame(rows))
    assert list(ours) == [f'decoder_test_rmse_{k}-step'
                          for k in range(2, 7)] + ['encoder_test_rmse_orig']
    if n_seeds == 1:          # a NaN interval prints as 0.00
        assert r'$\pm$0.00' in ours['encoder_test_rmse_orig']
    assert generate_main_results_table(rows[-1:]) == {}


def test_ci_and_format():
    assert math.isnan(ci([1.0]))
    assert 0 < ci([1.0, 1.1, 0.9, 1.05, 0.95]) < 0.2
    assert custom_format(0.123456) == '0.12'
    assert custom_format(1.2e-4) == '1.20e-04'
    assert custom_format(0.0) == '0.00'


# (change, what the error names; None: served; 'harness': a served setting
# of the sweep harness, checked by `_check_harness_setting`); the first
# seven keep their order
LATER = [
    (dict(tune_hparams=True), 'harness'),
    (dict(load_from_cache=True), 'harness'),
    (dict(resume_log='run.txt'), 'harness'),
    (dict(isolate_runs=True), 'harness'),
    (dict(metrics_jsonl='metrics.jsonl'), 'harness'),
    (dict(methods=('ct',)), None),
    (dict(methods=('wsindy',)), None),
    (dict(force_recache=True), 'harness'),
    (dict(methods=('msm', 'crn')), None),
    (dict(methods=('rmsn',)), None),
    (dict(methods=('gnet',)), None),
    (dict(methods=('edct',)), None),
    (dict(methods=('lstm',)), 'method lstm .not in the JAX package')]


def _check_harness_setting(cfg, change, monkeypatch, tmp_path):
    """The sweep with ``change`` serves it: a tuned lam on the insite row,
    a collection read back from the cache (or, with force_recache, stored
    without reading), the rows of a resumed log reused without a run, the
    in-process row from a fresh interpreter, the run's two JSONL records."""
    from insite_tpu_torch.harness import cache
    monkeypatch.setattr(cache, 'CACHE_DIR', str(tmp_path / 'cache'))
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    made = []
    real_make = runner.make_collection

    def make_collection(*args, **kwargs):
        made.append(args[0])
        return real_make(*args, **kwargs)

    monkeypatch.setattr(runner, 'make_collection', make_collection)
    plain = dataclasses.replace(cfg, metrics_jsonl='')
    cfg = dataclasses.replace(plain, **change)
    name = next(iter(change))
    if name == 'tune_hparams':
        cfg.methods = ('sindy', 'insite')
    if name == 'metrics_jsonl':
        cfg.metrics_jsonl = str(tmp_path / 'metrics.jsonl')
    if name == 'resume_log':
        cfg.resume_log = str(tmp_path / 'run.txt')
        log = logging.getLogger('later_resume')
        log.addHandler(logging.FileHandler(cfg.resume_log))
        log.setLevel(logging.INFO)
        ref, _ = runner.sweep(plain, log=log, **F64)
        made.clear()
        rows, _ = runner.sweep(cfg, log=log, **F64)
        assert rows == ref and made == []
        return
    rows, _ = runner.sweep(cfg, **F64)
    assert [r['errored'] for r in rows] == [False] * len(cfg.methods)
    if name == 'tune_hparams':
        assert 'tuned_lam' not in rows[0]
        assert list(rows[1])[0] == 'tuned_lam'
        assert rows[1]['tuned_lam'] in tuning.INSITE_LAM_GRID
    elif name in ('load_from_cache', 'force_recache'):
        again, _ = runner.sweep(cfg, **F64)
        assert made == ['EQ_4_A'] * (1 if name == 'load_from_cache' else 2)
        assert [_no_time(r) for r in again] == [_no_time(r) for r in rows]
        assert len(list((tmp_path / 'cache').glob('*.pkl'))) == 1
    elif name == 'isolate_runs':
        assert made == []           # the child made the collection
        ref, _ = runner.sweep(plain, **F64)
        assert [_no_time(r) for r in rows] == [_no_time(r) for r in ref]
    else:
        recs = [json.loads(line) for line in open(cfg.metrics_jsonl)]
        assert [r['kind'] for r in recs] == ['params', 'metrics']
        assert recs[1]['encoder_test_rmse_orig'] == \
            rows[0]['encoder_test_rmse_orig']


def _no_time(row):
    return {k: v for k, v in row.items() if k != 'seconds_taken'}


@pytest.mark.parametrize('change', [c for c, _ in LATER])
def test_later_slices_raise(change, monkeypatch, tmp_path):
    """The sweep harness's settings are served, each with its effect
    (`_check_harness_setting`), wsindy and the neural baselines are served
    (2 epochs), and a method the JAX package does not have raises, named,
    from the sweep and from a single run."""
    named = dict((repr(c), n) for c, n in LATER)[repr(change)]
    cfg = RunConfig(methods=('sindy',), datasets=('EQ_4_A',), seed_runs=1,
                    **TINY)
    if named == 'harness':
        _check_harness_setting(cfg, change, monkeypatch, tmp_path)
        return
    for k, v in change.items():
        setattr(cfg, k, v)
    if named is None:
        cfg.epochs = 2
        rows, _ = runner.sweep(cfg, device='cpu', dtype=torch.float64)
        assert [(r['method_name'], r['errored']) for r in rows] == [
            (m, False) for m in cfg.methods]
        for r in rows:
            assert 0 < r['encoder_test_rmse_orig'] < 100
            assert np.isfinite(r['decoder_test_rmse_6-step'])
            assert ('fine_tuned' in r) is (r['method_name'] == 'wsindy')
        if cfg.methods == ('wsindy',):
            assert rows[0]['fine_tuned'] is False
            assert rows[0]['encoder_test_rmse_orig'] < 1
        return
    with pytest.raises(NotImplementedError, match=named):
        runner.sweep(cfg, device='cpu')
    with pytest.raises(NotImplementedError, match=named):
        runner.run_experiment('EQ_4_A', cfg.methods[-1], 0, 2.0, cfg,
                              device='cpu')


@pytest.mark.parametrize('experiment', [e for e in runner.Experiment
                                        if e != runner.Experiment.MAIN_TABLE])
def test_other_experiments_raise(experiment, monkeypatch):
    """``tune_hparams`` is served in every experiment other than the main
    table: insite's row carries the tuned lam, and a neural method's the
    hparams of its one-point grid, both ahead of the test metrics, one row
    each of the experiment's first setting."""
    monkeypatch.setitem(tuning.NEURAL_HPARAM_GRIDS, 'rmsn',
                        {'enc_lr': [0.001], 'dec_dropout': [0.1]})
    cfg = RunConfig(methods=('insite', 'rmsn'), datasets=('EQ_4_A',),
                    seed_runs=1, tune_hparams=True, tune_trials=1, epochs=1,
                    domain_confs=(3,), noise_scales=(0.5,),
                    train_sample_grid=(30,), metrics_jsonl='', **TINY)
    rows, _ = runner.sweep(cfg, experiment, device='cpu',
                           dtype=torch.float64)
    assert [(r['method_name'], r['errored']) for r in rows] == [
        ('insite', False), ('rmsn', False)]
    insite, rnn = rows
    assert list(insite)[0] == 'tuned_lam'
    assert insite['tuned_lam'] in tuning.INSITE_LAM_GRID
    assert list(rnn)[0] == 'tuned_hparams'
    assert rnn['tuned_hparams'] == {'dec_dropout': 0.1, 'enc_lr': 0.001}
    assert ast.literal_eval(repr(rnn)) == rnn
    for r in rows:
        assert np.isfinite(r['encoder_test_rmse_orig'])


@pytest.mark.parametrize('experiment', [e for e in runner.Experiment
                                        if e != runner.Experiment.MAIN_TABLE])
def test_every_experiment_runs_a_row(experiment):
    """No experiment raises: the two ablations and the recovery run a row
    of the configured dataset, and the three sweeps over gamma, noise and
    cohort size run one row per setting on their own EQ_4 dataset, whatever
    ``cfg.datasets`` says."""
    cfg = RunConfig(methods=('sindy',), datasets=('EQ_4_A',), seed_runs=1,
                    domain_confs=(3,), noise_scales=(0.5,),
                    train_sample_grid=(30,), **TINY)
    rows, tables = runner.sweep(cfg, experiment, device='cpu',
                                dtype=torch.float64)
    assert [r['errored'] for r in rows] == [False]
    joint = experiment == runner.Experiment.ABLATION_ONE_ODE
    assert rows[0]['global_equation_string'].startswith(
        'Joint Model' if joint else 'Treatment 0')
    assert 'encoder_test_rmse_orig' in tables
    want = {'INSIGHT_CONFOUNDING': ('EQ_4_D', 3, {}),
            'INSIGHT_NOISE': ('EQ_4_B', 2.0, {'noise_scale': 0.5}),
            'INSIGHT_LESS_SAMPLES': ('EQ_4_D', 2.0, {'train_samples': 30})
            }.get(experiment.name, ('EQ_4_A', 2.0, {}))
    assert (rows[0]['dataset_name'], rows[0]['domain_conf']) == want[:2]
    assert {k: rows[0].get(k) for k in ('noise_scale', 'train_samples')
            if k in rows[0]} == want[2]


def test_rows_hold_plain_values_only():
    row = runner._plain({'a': np.float64(0.5), 'b': np.int64(3),
                         'c': np.bool_(True), 'd': 'x'})
    assert row == {'a': 0.5, 'b': 3, 'c': True, 'd': 'x'}
    assert type(row['a']) is float and type(row['b']) is int
    assert repr(row) == "{'a': 0.5, 'b': 3, 'c': True, 'd': 'x'}"
    with pytest.raises(TypeError):
        runner._plain({'a': np.zeros(2)})
    # (nested) lists of plain values stay literals
    nested = runner._plain({'m': [[np.float64(0.5), 1.0], [2.0, 3.0]],
                            't': (np.int64(1), 2)})
    assert nested == {'m': [[0.5, 1.0], [2.0, 3.0]], 't': [1, 2]}
    assert ast.literal_eval(repr(nested)) == nested
    assert type(nested['m'][0][0]) is float
    with pytest.raises(TypeError):
        runner._plain({'m': [[0.5, np.zeros(2)]]})


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present: --device cuda would run the sweep')
    with pytest.raises(RuntimeError, match='cuda'):
        run.main(['--flush', '--datasets', 'EQ_4_D', '--methods', 'sindy'])


# ---------------------------------------------------------------------------
# msm and the INSIGHT sweeps

def _hand_over_jax_cohorts(monkeypatch):
    """Let the port's runner take every cohort from the JAX package (the
    packages' EQ_4 generators differ), handed over in float64 with
    `convert.collection_from_numpy`, and record what it was asked for."""
    asked = []

    def make_collection(dataset_name, num_patients, seed, coeff, *, device,
                        dtype=None, **kwargs):
        asked.append(dict(kwargs, dataset_name=dataset_name, coeff=coeff,
                          num_patients=dict(num_patients)))
        ref = jax_make_collection(dataset_name, num_patients, seed, coeff,
                                  dtype=jnp.float64, **kwargs)
        raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
        return convert.collection_from_numpy(
            raw, ref.train_scaling_params, dataset_name,
            projection_horizon=ref.projection_horizon,
            treatment_mode=kwargs['treatment_mode'], seed=seed)

    monkeypatch.setattr(runner, 'make_collection', make_collection)
    return asked


RMSE_KEYS = ['encoder_test_rmse_all', 'encoder_test_rmse_orig',
             'encoder_test_rmse_last'] + [f'decoder_test_rmse_{k}-step'
                                          for k in range(2, 7)]


@pytest.mark.parametrize('dataset', ['EQ_4_D', 'cancer_sim', 'EQ_5_C'])
def test_msm_row_matches_jax(monkeypatch, dataset):
    """An msm row has the JAX row's keys in its order (no
    `global_equation_string`, no `fine_tuned`) and, on the same cohort, its
    RMSEs; on EQ_5 the chemo dosage stays out of msm's covariates."""
    asked = _hand_over_jax_cohorts(monkeypatch)
    sizes = dict(train_samples=30, val_samples=6, test_samples=6)
    ref = jax_run_experiment(dataset, 'msm', seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', epochs=40,
                                              **sizes))
    ours = runner.run_experiment(dataset, 'msm', seed=0, domain_conf=2.0,
                                 cfg=RunConfig(epochs=40, **sizes),
                                 device='cpu', dtype=torch.float64)
    assert list(ours) == list(ref) == RMSE_KEYS + ['method', 'seed',
                                                   'seconds_taken']
    for k in RMSE_KEYS:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12, err_msg=k)
    assert asked[0]['treatment_mode'] == 'multilabel'
    assert runner._plain(ours) == ours


def test_collection_mode_follows_the_method(monkeypatch):
    """The SINDy family runs multiclass (multilabel under the one-ODE
    ablation); msm runs multilabel in every experiment."""
    asked = _hand_over_jax_cohorts(monkeypatch)
    cfg = RunConfig(train_samples=8, val_samples=2, test_samples=2)
    for method, experiment, mode in (
            ('msm', 'MAIN_TABLE', 'multilabel'),
            ('sindy', 'MAIN_TABLE', 'multiclass'),
            ('insite', 'INSIGHT_NOISE', 'multiclass'),
            ('msm', 'INSIGHT_CONFOUNDING', 'multilabel'),
            ('wsindy', 'ABLATION_ONE_ODE', 'multilabel'),
            ('msm', 'ABLATION_ONE_ODE', 'multilabel')):
        coll = runner._collection_for('EQ_4_A', method, 0, 2.0, cfg,
                                      runner.Experiment[experiment],
                                      device='cpu')
        assert coll.treatment_mode == asked[-1]['treatment_mode'] == mode, \
            (method, experiment)


@pytest.mark.parametrize('method,n_cov', [('msm', 2), ('sindy', 3)])
def test_dosage_joins_the_sindy_family_only(method, n_cov):
    """On EQ_5 the chemo dosage is a covariate of the SINDy family, not of
    msm; msm's `max_epochs` is the run's `epochs` unless overridden."""
    cfg = RunConfig(train_samples=12, val_samples=2, test_samples=2,
                    epochs=7, model_overrides={'msm@EQ_5_D': {
                        'lag_features': 2}})
    coll = runner._collection_for('EQ_5_D', method, 0, 2.0, cfg,
                                  device='cpu', dtype=torch.float64)
    model = runner._build_model(method, 'EQ_5_D', coll, cfg, device='cpu',
                                dtype=torch.float64)
    assert coll.train_f.data['current_covariates'].shape[-1] == n_cov
    assert coll.train_f.data['static_features'].shape[-1] == n_cov - 1
    if method == 'msm':
        assert (model.cfg.max_epochs, model.cfg.lag_features) == (7, 2)
        assert model.cfg.dim_static_features == 1
        assert model.cfg.dim_treatments == 2
        assert runner._dims_from_collection(coll) == dict(
            dim_outcome=1, dim_treatments=2, dim_static_features=1)


INSIGHT_GRIDS = {
    'INSIGHT_CONFOUNDING': dict(domain_confs=(1, 3)),
    'INSIGHT_NOISE': dict(noise_scales=(0.0, 2.0)),
    'INSIGHT_LESS_SAMPLES': dict(train_sample_grid=(16, 24))}


@pytest.mark.parametrize('experiment', list(INSIGHT_GRIDS))
def test_tiny_insight_sweep_matches_jax(monkeypatch, experiment):
    """Two settings x (sindy, msm) x one seed at ~20 patients: the JAX
    sweep's enumeration order, override keys and, on handed-over cohorts,
    its RMSEs (msm to rtol 1e-12, sindy to rtol 1e-8)."""
    asked = _hand_over_jax_cohorts(monkeypatch)
    kw = dict(methods=('sindy', 'msm'), seed_runs=1, seed_start=1,
              train_samples=20, val_samples=4, test_samples=4, epochs=30,
              datasets=('EQ_4_A',), **INSIGHT_GRIDS[experiment])
    df, _ = jax_sweep(JaxRunConfig(metrics_jsonl='', **kw),
                      JaxExperiment[experiment])
    rows, tables = runner.sweep(RunConfig(**kw),
                                runner.Experiment[experiment], device='cpu',
                                dtype=torch.float64)
    ref_rows = [{k: v for k, v in rec.items()
                 if not (isinstance(v, float) and math.isnan(v))}
                for rec in df.to_dict('records')]
    assert len(rows) == len(ref_rows) == 4
    override = {'INSIGHT_NOISE': 'noise_scale',
                'INSIGHT_LESS_SAMPLES': 'train_samples'}.get(experiment)
    for ours, ref in zip(rows, ref_rows):
        assert set(ours) == set(ref)
        for k in ('dataset_name', 'method_name', 'seed', 'domain_conf',
                  'errored', 'method') + ((override,) if override else ()):
            assert ours[k] == ref[k], k
            assert type(ours[k]) in (bool, int, float, str)
        rtol = 1e-12 if ours['method_name'] == 'msm' else 1e-8
        for k in RMSE_KEYS:
            np.testing.assert_allclose(ours[k], ref[k], rtol=rtol,
                                       err_msg=f'{ours["method_name"]} {k}')
    assert [r['method_name'] for r in rows] == ['sindy', 'msm'] * 2
    assert ('global_equation_string' in rows[0]
            and 'global_equation_string' not in rows[1])
    # the setting reached the collection
    if experiment == 'INSIGHT_CONFOUNDING':
        assert [a['coeff'] for a in asked] == [1.0, 1.0, 3.0, 3.0]
        assert [r['domain_conf'] for r in rows] == [1, 1, 3, 3]
    elif experiment == 'INSIGHT_NOISE':
        assert [a['noise_scale'] for a in asked] == [0.0, 0.0, 2.0, 2.0]
        assert {a['dataset_name'] for a in asked} == {'EQ_4_B'}
    else:
        assert [a['num_patients']['train'] for a in asked] == [16, 16, 24,
                                                               24]
    # all settings of a dataset pool into one table cell, as in the JAX
    # package
    assert tables['encoder_test_rmse_orig'] == jax_table(
        pd.DataFrame(rows))['encoder_test_rmse_orig']


def test_overlay_key_check_reads_five_entry_runs(caplog):
    """The overlay-key check takes the runs' first four entries: a key of
    an INSIGHT run matches, a typo is warned of."""
    cfg = RunConfig(methods=('msm',), seed_runs=1, train_samples=12,
                    val_samples=2, test_samples=2, noise_scales=(0.5,),
                    model_overrides={'msm@EQ_4_B/2': {'lag_features': 1},
                                     'msm@EQ_4_D': {'lag_features': 1}})
    with caplog.at_level('WARNING', logger='insite_tpu_torch'):
        rows, _ = runner.sweep(cfg, runner.Experiment.INSIGHT_NOISE,
                               device='cpu', dtype=torch.float64)
    assert [r['errored'] for r in rows] == [False]
    warned = [r.message for r in caplog.records if 'model_overrides' in
              r.message]
    assert len(warned) == 1 and "['msm@EQ_4_D']" in warned[0]


def test_cli_insight_sweep_with_epochs(tmp_path):
    """`--epochs` reaches the config (msm's propensity fits read it), and an
    INSIGHT log reads back with its override column in both packages."""
    log_path = run.main(['--device', 'cpu', '--experiment',
                         'INSIGHT_LESS_SAMPLES', '--methods', 'sindy', 'msm',
                         '--seeds', '1', '--epochs', '3', '--val-samples',
                         '4', '--test-samples', '2', '--log-dir',
                         str(tmp_path)])
    text = open(log_path).read()
    assert '"epochs": 3' in text and 'INSIGHT_LESS_SAMPLES' in text
    rows = rows_from_log(log_path)
    assert [(r['method_name'], r['train_samples']) for r in rows] == [
        (m, n) for n in (50, 100, 250, 500, 1000) for m in ('sindy', 'msm')]
    assert not any(r['errored'] for r in rows)
    ref = df_from_log(log_path)
    assert list(ref['train_samples']) == [r['train_samples'] for r in rows]
    assert list(ref['encoder_test_rmse_orig']) == \
        [r['encoder_test_rmse_orig'] for r in rows]


@pytest.mark.parametrize('method', ['ct', 'crn', 'rmsn', 'gnet', 'edct'])
def test_neural_vitals_raise(method):
    """A collection with a vitals stream raises for every neural method,
    naming the slice that brings it."""
    coll = runner._collection_for('EQ_4_D', method, 0, 2.0, RunConfig(**TINY),
                                  device='cpu')
    coll.has_vitals = True
    with pytest.raises(NotImplementedError, match='Slice 6c'):
        runner._build_model(method, 'EQ_4_D', coll, RunConfig(**TINY),
                            device='cpu')
