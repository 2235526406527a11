"""The port's figures (`harness/plots.py`) on the rows of a sweep log:
`_agg`, the per-group means and intervals every plot draws, against the
JAX package's pandas `_agg` over the same log (`df_from_log`), for each
plot's grouping and both error modes (rtol 1e-12; measured: 0, the same
compensated sums); and each figure renders a PNG."""

import math

import numpy as np
import pytest

from insite_tpu.harness import plots as jax_plots
from insite_tpu.harness.results import df_from_log
from insite_tpu_torch.harness import plots
from insite_tpu_torch.harness.results import TAG, rows_from_log

METHODS = ('sindy', 'insite', 'msm')
STEPS = [f'decoder_test_rmse_{k}-step' for k in range(2, 7)]


def _write_log(path):
    """A log of a confounding sweep and a sample-size sweep: three
    methods, two datasets, two seeds; an errored row, a row logged with a
    'nan' RMSE and a row without ``train_samples``."""
    rs = np.random.RandomState(0)
    lines = []
    for ds in ('EQ_4_D', 'cancer_sim'):
        for method in METHODS:
            for gamma in (0.0, 2.0, 4.0):
                for n in (50, 1000):
                    for seed in (0, 1):
                        row = {'dataset_name': ds, 'method_name': method,
                               'seed': seed, 'domain_conf': gamma,
                               'train_samples': n,
                               'encoder_test_rmse_orig': float(rs.rand()),
                               'encoder_test_rmse_all': float(rs.rand())}
                        row.update({c: float(rs.rand() * k)
                                    for k, c in enumerate(STEPS, 2)})
                        row.update(errored=False, seconds_taken=1.5)
                        lines.append(row)
    lines[3]['errored'] = True
    lines[5]['encoder_test_rmse_all'] = math.nan
    del lines[8]['train_samples']
    with open(path, 'w') as f:
        for row in lines:
            f.write('2026-01-01 00:00:00,000 INFO ' + TAG + repr(row) + '\n')
    return path


@pytest.fixture(scope='module')
def log(tmp_path_factory):
    return _write_log(tmp_path_factory.mktemp('plots') / 'run.txt')


@pytest.mark.parametrize('group_cols', [
    ['dataset_name', 'method_name'], ['method_name', 'domain_conf'],
    ['method_name', 'train_samples']], ids=['n-step', 'confounding',
                                            'sample-size'])
@pytest.mark.parametrize('use_95_ci', [True, False], ids=['ci', 'std'])
def test_agg_matches_jax(log, group_cols, use_95_ci):
    rows = rows_from_log(log)
    means, errs, label = plots._agg(rows, group_cols, use_95_ci)
    ref_m, ref_e, ref_label = jax_plots._agg(df_from_log(log), group_cols,
                                            use_95_ci)
    assert label == ref_label
    assert list(means) == [k if isinstance(k, tuple) else (k,)
                           for k in ref_m.index]
    cols = list(next(iter(means.values())))
    assert cols == list(ref_m.columns)
    # the 'nan'-logged column is not numeric in either package
    assert 'encoder_test_rmse_all' not in cols and 'seed' in cols
    for key in means:
        for got, ref in ((means, ref_m), (errs, ref_e)):
            want = ref.loc[key].to_numpy(float)
            np.testing.assert_allclose([got[key][c] for c in cols], want,
                                       rtol=1e-12, atol=0, equal_nan=True)
    if 'train_samples' not in group_cols:
        # the row without train_samples: its group's interval is NaN
        nan_errs = sum(math.isnan(e['train_samples']) for e in errs.values())
        assert (nan_errs > 0) == use_95_ci


def test_figures_render(log, tmp_path):
    rows = rows_from_log(log)
    paths = [
        plots.plot_n_step_rmses(rows, str(tmp_path / 'n_step.png')),
        plots.plot_n_step_rmses(rows, str(tmp_path / 'n_step_g0.png'),
                                domain_conf=0.0, use_95_ci=False),
        plots.plot_confounding_sweep(rows, str(tmp_path / 'conf.png')),
        plots.plot_sample_efficiency(rows, str(tmp_path / 'samples.png')),
        plots.plot_recovered_dist(
            {'arm 0': {'true': [1.0, 1.2, 0.9], 'recovered': [1.1, 1.2, 0.8]},
             'arm 1': {'true': [0.3, 0.5], 'recovered': [0.35, 0.45]}},
            str(tmp_path / 'recovered.png'))]
    for p in paths:
        with open(p, 'rb') as f:
            assert f.read(8) == b'\x89PNG\r\n\x1a\n'


def test_n_step_needs_step_columns(tmp_path):
    rows = [{'dataset_name': 'EQ_4_D', 'method_name': 'sindy',
             'encoder_test_rmse_orig': 0.1}]
    with pytest.raises(ValueError, match='decoder_test_rmse'):
        plots.plot_n_step_rmses(rows, str(tmp_path / 'x.png'))
