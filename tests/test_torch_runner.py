"""The sweep harness: the port's run rows against the JAX package's, a CPU
sweep through `python -m insite_tpu_torch.run` whose log the JAX parser
reads, and the LaTeX main table against the JAX package's text."""

import math

import numpy as np
import pandas as pd
import pytest
import torch

from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.results import df_from_log
from insite_tpu.harness.results import \
    generate_main_results_table as jax_table
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu_torch import run
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.results import (ci, custom_format,
                                              generate_main_results_table,
                                              rows_from_log)

TINY = dict(train_samples=40, val_samples=4, test_samples=2)
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


@pytest.mark.parametrize('change', [
    dict(tune_hparams=True), dict(load_from_cache=True),
    dict(resume_log='logs/run.txt'), dict(isolate_runs=True),
    dict(metrics_jsonl='logs/metrics.jsonl'), dict(methods=('ct',)),
    dict(methods=('wsindy',))])
def test_later_slices_raise(change):
    cfg = RunConfig(methods=('sindy',), datasets=('EQ_4_A',), seed_runs=1,
                    **TINY)
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError):
        runner.sweep(cfg, device='cpu')


@pytest.mark.parametrize('experiment', [e for e in runner.Experiment
                                        if e != runner.Experiment.MAIN_TABLE])
def test_other_experiments_raise(experiment):
    cfg = RunConfig(methods=('sindy',), datasets=('EQ_4_A',), **TINY)
    with pytest.raises(NotImplementedError, match=experiment.name):
        runner.sweep(cfg, experiment, device='cpu')


def test_rows_hold_plain_values_only():
    row = runner._plain({'a': np.float64(0.5), 'b': np.int64(3),
                         'c': np.bool_(True), 'd': 'x'})
    assert row == {'a': 0.5, 'b': 3, 'c': True, 'd': 'x'}
    assert type(row['a']) is float and type(row['b']) is int
    assert repr(row) == "{'a': 0.5, 'b': 3, 'c': True, 'd': 'x'}"
    with pytest.raises(TypeError):
        runner._plain({'a': np.zeros(2)})


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present: --device cuda would run the sweep')
    with pytest.raises(RuntimeError, match='cuda'):
        run.main(['--flush', '--datasets', 'EQ_4_D', '--methods', 'sindy'])
