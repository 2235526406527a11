"""The sweep harness around the runs, against the JAX package where it has
a counterpart: the dataset cache (keyed by device and dtype as well), sweep
resume with its fingerprint check, isolated runs and columns, the JSONL
metrics sink, `RunConfig.from_yaml`, the paper-format and parity tables
(equal strings on the same rows), and the CLI's flags."""

import dataclasses
import json
import logging
import math

import numpy as np
import pandas as pd
import pytest
import torch

from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.metrics_logger import MetricsLogger as JaxLogger
from insite_tpu.harness.results import \
    generate_main_results_table_paper_format as jax_paper_table
from insite_tpu.harness.results import parity_table as jax_parity_table
from insite_tpu_torch import run
from insite_tpu_torch.harness import cache, isolated, runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.metrics_logger import MetricsLogger
from insite_tpu_torch.harness.results import (
    generate_main_results_table_paper_format, parity_table, rows_from_log)

TINY = dict(train_samples=40, val_samples=4, test_samples=2)
F64 = dict(device='cpu', dtype=torch.float64)
torch.set_num_threads(1)


def _no_time(row):
    return {k: v for k, v in row.items() if k != 'seconds_taken'}


def _file_logger(path, name):
    """A logger writing the sweep's lines to ``path`` only."""
    log = logging.getLogger(name)
    for h in list(log.handlers):
        log.removeHandler(h)
    log.addHandler(logging.FileHandler(path))
    log.setLevel(logging.INFO)
    log.propagate = False
    return log


# ---------------------------------------------------------------------------
# the dataset cache

def test_cache_round_trip_and_key(monkeypatch, tmp_path):
    """A cached collection comes back equal and skips the simulation; the
    key holds the device type and the dtype, so a cohort drawn on the host
    (or in another type) is never served for the card."""
    monkeypatch.setattr(cache, 'CACHE_DIR', str(tmp_path))
    made = []
    real_make = runner.make_collection

    def make_collection(name, num_patients, seed, *args, device, **kw):
        made.append((torch.device(device).type, kw.get('dtype')))
        if torch.device(device).type == 'cuda':
            return {'stub': 'drawn on the card'}
        return real_make(name, num_patients, seed, *args, device=device,
                         **kw)

    monkeypatch.setattr(runner, 'make_collection', make_collection)
    cfg = RunConfig(load_from_cache=True, **TINY)
    first = runner._collection_for('EQ_4_A', 'sindy', 0, 2.0, cfg, **F64)
    again = runner._collection_for('EQ_4_A', 'sindy', 0, 2.0, cfg, **F64)
    assert len(made) == 1
    np.testing.assert_array_equal(again.train_f.data['cancer_volume'],
                                  first.train_f.data['cancer_volume'])
    runner._collection_for('EQ_4_A', 'sindy', 0, 2.0, cfg, device='cpu')
    card = runner._collection_for('EQ_4_A', 'sindy', 0, 2.0, cfg,
                                  device=torch.device('cuda', 0))
    assert card == {'stub': 'drawn on the card'}
    assert made == [('cpu', torch.float64), ('cpu', None), ('cuda', None)]
    assert len(list(tmp_path.glob('collection_*.pkl'))) == 3
    # force_recache stores without reading
    runner._collection_for('EQ_4_A', 'sindy', 0, 2.0,
                           dataclasses.replace(cfg, force_recache=True),
                           **F64)
    assert len(made) == 4
    assert cache.get_cached(('missing',)) is None


def test_cached_run_repeats_its_row(monkeypatch, tmp_path):
    monkeypatch.setattr(cache, 'CACHE_DIR', str(tmp_path))
    cfg = RunConfig(load_from_cache=True, metrics_jsonl='', **TINY)
    rows = [runner.run_experiment('EQ_4_D', 'insite', 0, 2.0, cfg, **F64)
            for _ in range(2)]
    assert _no_time(rows[0]) == _no_time(rows[1])


# ---------------------------------------------------------------------------
# resume

def _counting(monkeypatch):
    calls = []
    real_run = runner.run_experiment

    def counting_run(*a, **k):
        calls.append(a[:3])
        return real_run(*a, **k)

    monkeypatch.setattr(runner, 'run_experiment', counting_run)
    return calls


def test_resume_skips_completed_runs(monkeypatch, tmp_path):
    """A resumed sweep re-logs the rows of its log's completed runs and
    executes only the rest; a reused row carries the original metrics, its
    NaN cells dropped."""
    base = dict(methods=('sindy',), datasets=('EQ_4_D',), metrics_jsonl='',
                **TINY)
    log_path = tmp_path / 'first.txt'
    log = _file_logger(log_path, 'resume_test')
    rows1, _ = runner.sweep(RunConfig(seed_runs=1, **base), log=log,
                            **F64)
    calls = _counting(monkeypatch)
    rows2, _ = runner.sweep(RunConfig(seed_runs=2, resume_log=str(log_path),
                                      **base), log=log, **F64)
    assert calls == [('EQ_4_D', 'sindy', 1)]
    assert rows2[0] == rows1[0]
    assert [r['seed'] for r in rows2] == [0, 1]
    assert len(rows_from_log(log_path)) == 3


def test_resume_drops_nan_cells_and_errored_rows(monkeypatch, tmp_path):
    log_path = tmp_path / 'old.txt'
    fp = runner._sweep_fingerprint(RunConfig(seed_runs=2, **TINY),
                                   'MAIN_TABLE')
    row = {'encoder_test_rmse_orig': 0.5, 'decoder_test_rmse_2-step':
           float('nan'), 'errored': False, 'dataset_name': 'EQ_4_D',
           'seed': 0, 'method_name': 'sindy', 'domain_conf': 2.0}
    bad = dict(row, seed=1, errored=True)
    log_path.write_text(
        f'x INFO [Sweep config] {json.dumps(fp, sort_keys=True)}\n'
        f'x INFO [Exp evaluation complete] {row}\n'
        f'x INFO [Exp evaluation complete] {bad}\n')
    done = runner._completed_runs(RunConfig(resume_log=str(log_path)),
                                  runner.Experiment.MAIN_TABLE, fp,
                                  runner._read_sweep_fingerprints(log_path),
                                  logging.getLogger('resume_nan'))
    key = runner._resume_key('EQ_4_D', 'sindy', 0, 2.0, {})
    assert list(done) == [key]
    assert 'decoder_test_rmse_2-step' not in done[key]


@pytest.mark.parametrize('appended', [False, True])
def test_resume_refuses_a_config_mismatch(monkeypatch, tmp_path, appended):
    """Rows logged under another sweep config are never reused; with
    several sweeps appended to one log, every fingerprint is checked, not
    only the last."""
    base = dict(methods=('sindy',), seed_runs=1, metrics_jsonl='', **TINY)
    log_path = tmp_path / 'smoke.txt'
    log = _file_logger(log_path, f'resume_fp_{appended}')
    runner.sweep(RunConfig(datasets=('EQ_4_D',), epochs=7, **base), log=log,
                 **F64)
    if appended:
        runner.sweep(RunConfig(datasets=('EQ_4_A',), epochs=9, **base),
                     log=log, **F64)
    calls = _counting(monkeypatch)
    rows, _ = runner.sweep(RunConfig(datasets=('EQ_4_D',), epochs=9,
                                     resume_log=str(log_path), **base),
                           log=log, **F64)
    assert calls == [('EQ_4_D', 'sindy', 0)]
    assert len(rows) == 1


# ---------------------------------------------------------------------------
# isolation

@pytest.fixture
def one_thread_children(monkeypatch):
    """A child's plain rollouts are many tiny ops: one intra-op thread, as
    in this process."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')


def test_run_isolated_matches_in_process(one_thread_children):
    """The child's row is the in-process row (the same program on the same
    host); a failing child raises, and nothing runs in the parent."""
    cfg = RunConfig(metrics_jsonl='', **TINY)
    ours = isolated.run_isolated('EQ_4_D', 'insite', 0, 2.0, cfg,
                                 runner.Experiment.MAIN_TABLE, **F64)
    ref = runner.run_experiment('EQ_4_D', 'insite', 0, 2.0, cfg, **F64)
    assert list(ours) == list(ref)
    assert _no_time(ours) == _no_time(ref)
    with pytest.raises(RuntimeError, match='isolated run'):
        isolated.run_isolated('NO_SUCH_DATASET', 'sindy', 0, 2.0, cfg,
                              runner.Experiment.MAIN_TABLE, device='cpu')


def test_run_isolated_column(one_thread_children):
    """A vectorized column in a child returns the in-process column; a
    column without a path is skipped in the parent too."""
    cfg = RunConfig(seed_runs=2, metrics_jsonl='', **TINY)
    r, seeds = isolated.run_isolated_column('EQ_4_D', 'insite', cfg, **F64)
    ref, ref_seeds = runner._vectorized_column(cfg, 'EQ_4_D', 'insite',
                                               **F64)
    assert seeds == ref_seeds == [0, 1]
    assert set(r) == {k for k, v in ref.items()
                      if isinstance(v, np.ndarray) and v.ndim == 1}
    for k in r:
        np.testing.assert_array_equal(r[k], ref[k], err_msg=k)
    with pytest.raises(runner.ColumnSkipped):
        isolated.run_isolated_column('cancer_sim', 'wsindy', cfg, **F64)


# ---------------------------------------------------------------------------
# the metrics sink, the YAML config

def test_metrics_logger_jsonl(tmp_path):
    """The port's records are the JAX package's, the time stamp aside."""
    records = []
    for cls in (MetricsLogger, JaxLogger):
        path = str(tmp_path / f'{cls.__module__}.jsonl')
        ml = cls(path, run_name='test-run')
        ml.log_params({'lam': 10.0, 'nested': {'a': 1}, 'multi': {'b': 2}},
                      submodel='multi')
        ml.log_metrics({'val_rmse_all': 0.5, 'skipped_str': 'x', 'n': 3},
                       step=3)
        ml.finish()
        records.append([{k: v for k, v in json.loads(line).items()
                         if k != 'ts'} for line in open(path)])
    ours, ref = records
    assert ours == ref
    assert [r['kind'] for r in ours] == ['params', 'metrics']
    assert 'nested' not in ours[0] and ours[0]['multi'] == '{"b": 2}'
    assert ours[1] == {'run': 'test-run', 'kind': 'metrics', 'step': 3,
                       'val_rmse_all': 0.5, 'n': 3.0}


def test_every_run_writes_the_sink(tmp_path):
    path = tmp_path / 'logs' / 'metrics.jsonl'
    cfg = RunConfig(methods=('sindy', 'insite'), datasets=('EQ_4_A',),
                    seed_runs=1, metrics_jsonl=str(path), **TINY)
    rows, _ = runner.sweep(cfg, **F64)
    recs = [json.loads(line) for line in open(path)]
    assert [(r['run'], r['kind']) for r in recs] == [
        (f'{m}-EQ_4_A-0', k) for m in ('sindy', 'insite')
        for k in ('params', 'metrics')]
    assert recs[1]['encoder_test_rmse_orig'] == \
        rows[0]['encoder_test_rmse_orig']
    assert RunConfig().metrics_jsonl == JaxRunConfig().metrics_jsonl


def test_from_yaml_matches_jax(tmp_path):
    """The repo's tuned preset and a small sweep file load as in the JAX
    package; keyword overrides win; unknown fields and a non-mapping
    raise."""
    preset = 'configs/ref_tuned.yaml'
    ours = RunConfig.from_yaml(preset, epochs=3)
    assert dataclasses.asdict(ours) == dataclasses.asdict(
        JaxRunConfig.from_yaml(preset, epochs=3))
    assert ours.model_overrides and ours.epochs == 3
    p = tmp_path / 'sweep.yaml'
    p.write_text('methods: [sindy, insite]\nseed_runs: 3\nepochs: 5\n')
    cfg = RunConfig.from_yaml(str(p), epochs=7)
    assert (cfg.methods, cfg.seed_runs, cfg.epochs) == (('sindy', 'insite'),
                                                        3, 7)
    assert RunConfig.from_dict(dataclasses.asdict(cfg)) == cfg
    bad = tmp_path / 'bad.yaml'
    bad.write_text('not_a_field: 1\n')
    with pytest.raises(ValueError, match='unknown RunConfig fields'):
        RunConfig.from_yaml(str(bad))
    with pytest.raises(ValueError, match='override'):
        RunConfig.from_yaml(str(p), nope=1)
    listed = tmp_path / 'list.yaml'
    listed.write_text('- 1\n- 2\n')
    with pytest.raises(ValueError, match='mapping'):
        RunConfig.from_yaml(str(listed))


# ---------------------------------------------------------------------------
# tables

def _rows(methods, n_seeds=3, datasets=('EQ_4_D', 'EQ_4_A', 'cancer_sim')):
    rng = np.random.RandomState(n_seeds)
    rows = []
    for seed in range(n_seeds):
        for ds in datasets:
            for m in methods:
                row = {'encoder_test_rmse_orig': float(rng.rand())}
                row.update({f'decoder_test_rmse_{k}-step':
                            float(rng.rand() * 10 ** -rng.randint(0, 4))
                            for k in range(2, 7)})
                row.update(method=m, seed=seed, errored=False,
                           dataset_name=ds, method_name=m, domain_conf=2.0)
                rows.append(row)
    rows[1]['decoder_test_rmse_3-step'] = math.nan
    rows.append({'errored': True, 'dataset_name': 'EQ_4_B', 'seed': 0,
                 'method_name': 'sindy', 'domain_conf': 2.0})
    return rows


@pytest.mark.parametrize('methods', [
    ('insite', 'msm', 'sindy', 'ct'), ('insite', 'wsindy'), ('crn', 'rmsn')],
    ids=['both-groups', 'ode-only', 'lte-only'])
def test_paper_format_tables_match_jax(methods):
    rows = _rows(methods)
    ours = generate_main_results_table_paper_format(rows)
    assert ours == jax_paper_table(pd.DataFrame(rows))
    assert list(ours) == [f'decoder_test_rmse_{k}-step' for k in range(2, 7)]
    t = ours['decoder_test_rmse_6-step']
    assert (r'\rotatebox{90}{\bf ODE-D}' in t) is ('insite' in methods)
    assert (r'\rotatebox{90}{\bf LTE}' in t) is ('crn' in methods or
                                                 'msm' in methods)
    assert generate_main_results_table_paper_format(rows[-1:]) == {}


def test_parity_table_matches_jax():
    ours_rows = _rows(('insite', 'rmsn'))
    ref_rows = _rows(('insite', 'msm'), n_seeds=2,
                     datasets=('EQ_4_D', 'EQ_4_C'))
    md = parity_table(ours_rows, ref_rows)
    assert md == jax_parity_table(pd.DataFrame(ours_rows),
                                  pd.DataFrame(ref_rows))
    assert '| EQ_4_D | insite | 3 |' in md and '**' in md
    metrics = ('decoder_test_rmse_3-step', 'decoder_test_rmse_2-step')
    assert parity_table(ours_rows, ref_rows, metrics) == jax_parity_table(
        pd.DataFrame(ours_rows), pd.DataFrame(ref_rows), metrics)
    assert 'no overlapping' in parity_table(ours_rows, ref_rows[:0])


# ---------------------------------------------------------------------------
# the CLI

def test_cli_flags_reach_the_config(monkeypatch, tmp_path):
    """A flag overrides the YAML file only when given; --isolate implies
    --no-debug."""
    seen = []

    def fake_sweep(cfg, experiment, log=None, **kw):
        seen.append(cfg)
        return [], {}

    monkeypatch.setattr(run, 'sweep', fake_sweep)
    p = tmp_path / 'sweep.yaml'
    p.write_text('methods: [crn]\nepochs: 5\ntune_trials: 4\n'
                 'tune_algo: sha\nlog_dir: ' + str(tmp_path) + '\n')
    run.main(['--device', 'cpu', '--config', str(p), '--epochs', '2'])
    run.main(['--device', 'cpu', '--config', str(p), '--tune',
              '--tune-trials', '2', '--tune-algo', 'grid', '--cache',
              '--isolate', '--resume', 'old.txt'])
    a, b = seen
    assert (a.methods, a.epochs, a.tune_trials, a.tune_algo) == (
        ('crn',), 2, 4, 'sha')
    assert not (a.tune_hparams or a.load_from_cache or a.isolate_runs)
    assert a.debug_mode and not a.resume_log
    assert (b.epochs, b.tune_hparams, b.tune_trials, b.tune_algo) == (
        5, True, 2, 'grid')
    assert b.load_from_cache and b.isolate_runs and not b.debug_mode
    assert b.resume_log == 'old.txt'


def test_cli_tune_then_resume(tmp_path):
    """`--tune` on a tiny sweep, then the same sweep at two seeds resumed
    from its log: seed 0's rows are reused, insite's with its tuned lam."""
    common = ['--device', 'cpu', '--tune', '--datasets', 'EQ_4_D',
              '--methods', 'sindy', 'insite', '--train-samples', '40',
              '--val-samples', '4', '--test-samples', '2', '--log-dir',
              str(tmp_path)]
    first = run.main(common + ['--seeds', '1'])
    rows1 = rows_from_log(first)
    second = run.main(common + ['--seeds', '2', '--resume', first])
    rows2 = rows_from_log(second)
    assert [(r['method_name'], r['seed']) for r in rows2] == [
        ('sindy', 0), ('insite', 0), ('sindy', 1), ('insite', 1)]
    assert rows2[:2] == rows1
    text = open(second).read()
    assert '[Resume] 2 completed runs' in text
    assert text.count('[Now evaluating exp]') == 2
    for r in rows2:
        assert ('tuned_lam' in r) is (r['method_name'] == 'insite')
    insite = rows2[1]
    assert list(insite)[0] == 'tuned_lam'
    assert insite['tuned_lam'] in (0.0, 10.0, 100.0, 200.0, 500.0, 1000.0,
                                   2000.0)
