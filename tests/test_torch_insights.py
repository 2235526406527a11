"""The parametric-distribution recovery (`harness/insights.py`) and the
sweep rows of the experiments beyond the main table, against the JAX
package in float64 on the CPU.

Tolerances: `recovered_arm_rates` is the same numpy arithmetic, equal;
`recover_parametric_dist` on a cohort shared through
`convert.collection_from_numpy` inherits the fine-tune's 1e-8 (its
Jacobian comes from forward sensitivities here and jvp there); a run's row
has the JAX package's keys in its order, and on the tumor family (equal
cohorts at equal seed) its RMSEs agree to rtol 1e-8."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.data.collection import PkpdDatasetCollection as JaxCollection
from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.harness import insights as jax_insights
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.results import df_from_log
from insite_tpu.harness.runner import Experiment as JaxExperiment
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu_torch import convert, run
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.harness import insights, runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.results import rows_from_log
from insite_tpu_torch.harness.runner import Experiment
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor

F64 = dict(device='cpu', dtype=torch.float64)
TINY = dict(train_samples=40, val_samples=4, test_samples=2)
torch.set_num_threads(1)


def test_recovered_arm_rates_equal_jax():
    rs = np.random.RandomState(0)
    coefs = rs.randn(6, 2, 7)
    values = {'u0': rs.rand(6), 'u1': rs.rand(6)}
    names = ['x0', 'u0', 'u1']
    got = insights.recovered_arm_rates(
        coefs, PolynomialLibrary(3).feature_names(names), values)
    want = jax_insights.recovered_arm_rates(
        coefs, JaxLibrary(3).feature_names(names), values)
    np.testing.assert_array_equal(got, want)
    # -(c_x0 + c_{x0 u0} u0 + c_{x0 u1} u1)
    np.testing.assert_allclose(
        got, -(coefs[:, :, 1] + coefs[:, :, 4] * values['u0'][:, None]
               + coefs[:, :, 5] * values['u1'][:, None]), rtol=1e-14)


def test_recovered_arm_rates_refuse_powers_of_x0():
    names = PolynomialLibrary(2, degree=2, interaction_only=False) \
        .feature_names(['x0', 'u0'])
    assert 'x0^2' in names
    with pytest.raises(ValueError, match='nonlinear in x0'):
        insights.recovered_arm_rates(np.zeros((3, 2, len(names))), names,
                                     {'u0': np.ones(3)})


def test_recover_parametric_dist_matches_jax_on_a_shared_cohort():
    ref = JaxCollection(2.0, {'train': 100, 'val': 12, 'test': 2}, 'EQ_4_D',
                        seed=0, dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, 'EQ_4_D', projection_horizon=5,
        treatment_mode='multiclass',
        sim_params={'val_f': ref.val_f.sim_params})
    cfg = dict(dataset_name='EQ_4_D', insite=True)
    model = SINDyRegressor(SINDyConfig(**cfg), ours, **F64).fit(ours.train_f)
    model_r = JaxRegressor(JaxConfig(**cfg), ref).fit(ref.train_f)
    got = insights.recover_parametric_dist(model, ours.val_f, raw=True)
    want = jax_insights.recover_parametric_dist(model_r, ref.val_f, raw=True)
    assert list(got) == list(want) == ['arm0', 'arm1']
    for arm in want:
        assert list(got[arm]) == list(want[arm])
        assert got[arm]['n'] == want[arm]['n'] > 1
        for k, v in want[arm].items():
            np.testing.assert_allclose(got[arm][k], v, rtol=1e-8,
                                       err_msg=f'{arm} {k}')
        assert got[arm]['pearson_r'] > 0.9
    # handing over the coefficients saves the fine-tune, not the answer
    c = model.get_fine_tuned_coefficients(ours.val_f)
    assert insights.recover_parametric_dist(model, ours.val_f, coefs=c) == \
        insights.recover_parametric_dist(model, ours.val_f)
    with pytest.raises(ValueError, match='no hidden decay constants'):
        insights.recover_parametric_dist(model, ours.train_f)


CELLS = [(Experiment.ABLATION_ONE_ODE, 'cancer_sim', 'insite'),
         (Experiment.ABLATION_ONE_ODE, 'EQ_4_D', 'sindy'),
         (Experiment.ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS, 'EQ_4_D',
          'sindy'),
         (Experiment.INSIGHT_RECOVER_PARAMETRIC_DIST, 'EQ_4_D', 'insite'),
         (Experiment.INSIGHT_RECOVER_PARAMETRIC_DIST, 'EQ_4_D', 'sindy'),
         (Experiment.MAIN_TABLE, 'cancer_sim', 'wsindy')]


@pytest.mark.parametrize('experiment, dataset, method', CELLS,
                         ids=[f'{e.name}-{d}-{m}' for e, d, m in CELLS])
def test_run_experiment_rows_match_jax(experiment, dataset, method):
    ref = jax_run_experiment(dataset, method, 0, 2.0,
                             JaxRunConfig(metrics_jsonl='', **TINY),
                             JaxExperiment[experiment.name])
    ours = runner.run_experiment(dataset, method, 0, 2.0, RunConfig(**TINY),
                                 experiment, device='cpu',
                                 dtype=torch.float64)
    assert list(ours) == list(ref)
    if dataset == 'cancer_sim':     # equal cohorts at equal seed
        for k in ('encoder_test_rmse_orig', 'decoder_test_rmse_6-step'):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-8)
    if experiment == Experiment.ABLATION_ONE_ODE:
        assert ours['global_equation_string'].startswith('Joint Model')
    if experiment == Experiment.ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS:
        # 35 features an arm: some monomial of degree 3 or 4 survives
        assert '^' in ours['global_equation_string']
    if 'coef_mean' in ref:
        assert method == 'insite'
        assert np.shape(ours['coef_mean']) == np.shape(ref['coef_mean']) \
            == (2, 7)
        assert np.shape(ours['coef_std']) == (2, 7)
        assert -1 <= ours['recover_arm0_pearson_r'] <= 1
        assert isinstance(ours['recover_arm0_n'], int)
    else:
        assert not any(k.startswith(('coef_', 'recover_')) for k in ours)


def test_cli_experiment_log_reads_back_in_both_packages(tmp_path):
    log_path = run.main(['--device', 'cpu', '--seeds', '1', '--experiment',
                         'INSIGHT_RECOVER_PARAMETRIC_DIST', '--datasets',
                         'EQ_4_D', '--methods', 'sindy', 'wsindy', 'insite',
                         '--train-samples', '40', '--val-samples', '4',
                         '--test-samples', '2', '--log-dir', str(tmp_path)])
    rows = rows_from_log(log_path)
    # the data frame pads the rows that lack the insite run's keys with NaN
    assert rows == [{k: v for k, v in r.items() if v == v}
                    for r in df_from_log(log_path).to_dict('records')]
    assert [r['method_name'] for r in rows] == ['sindy', 'wsindy', 'insite']
    assert not any(r['errored'] for r in rows)
    # the nested lists stay Python literals in the log
    assert np.shape(rows[2]['coef_mean']) == (2, 7)
    assert all(isinstance(x, float) for arm in rows[2]['coef_std']
               for x in arm)
    assert 'coef_mean' not in rows[0]
    text = open(log_path).read()
    assert '"experiment": "INSIGHT_RECOVER_PARAMETRIC_DIST"' in text
    assert 'Latex Table:: encoder_test_rmse_orig' in text


def test_cli_one_ode_sweep(tmp_path):
    log_path = run.main(['--device', 'cpu', '--seeds', '1', '--experiment',
                         'ABLATION_ONE_ODE', '--datasets', 'EQ_4_D',
                         'EQ_5_D', '--methods', 'sindy', 'insite',
                         '--train-samples', '40', '--val-samples', '4',
                         '--test-samples', '2', '--log-dir', str(tmp_path)])
    rows = rows_from_log(log_path)
    assert rows == df_from_log(log_path).to_dict('records')
    assert len(rows) == 4 and not any(r['errored'] for r in rows)
    assert all(r['global_equation_string'].startswith('Joint Model')
               for r in rows)
    for ds in ('EQ_4_D', 'EQ_5_D'):
        sindy, insite = (r for r in rows if r['dataset_name'] == ds)
        assert insite['encoder_test_rmse_orig'] < \
            sindy['encoder_test_rmse_orig']
