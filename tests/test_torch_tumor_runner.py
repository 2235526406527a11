"""The sweep on the tumor family: the port's run rows against the JAX
package's for cancer_sim (keys equal, RMSEs to rtol 1e-8), and a CPU sweep
through `python -m insite_tpu_torch.run` over cancer_sim and EQ_5_D whose
log both packages read back."""

import numpy as np
import pytest
import torch

from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.results import df_from_log
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu_torch import run
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.results import rows_from_log

TINY = dict(train_samples=40, val_samples=4, test_samples=2)
# the plain rollouts are thousands of small ops: one intra-op thread per
# test worker
torch.set_num_threads(1)


@pytest.mark.parametrize('method', ['sindy', 'insite'])
def test_run_experiment_row_matches_jax(method):
    ref = jax_run_experiment('cancer_sim', method, seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', **TINY))
    ours = runner.run_experiment('cancer_sim', method, seed=0,
                                 domain_conf=2.0, cfg=RunConfig(**TINY),
                                 device='cpu', dtype=torch.float64)
    assert list(ours) == list(ref)
    assert ours['global_equation_string'].count('Treatment') == 4
    # each package simulates its own cohort here: the same draws, volumes
    # equal to about 1e-12, so the RMSEs agree to rtol 1e-8
    for k in ('encoder_test_rmse_orig', 'decoder_test_rmse_6-step'):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-8)


def test_cli_tumor_sweep_log_reads_back_in_both_packages(tmp_path):
    log_path = run.main(['--device', 'cpu', '--seeds', '1', '--datasets',
                         'cancer_sim', 'EQ_5_D', '--methods', 'sindy',
                         'insite', '--train-samples', '40', '--val-samples',
                         '4', '--test-samples', '2', '--log-dir',
                         str(tmp_path)])
    rows = rows_from_log(log_path)
    assert rows == df_from_log(log_path).to_dict('records')
    assert [(r['dataset_name'], r['method_name']) for r in rows] == [
        ('cancer_sim', 'sindy'), ('cancer_sim', 'insite'),
        ('EQ_5_D', 'sindy'), ('EQ_5_D', 'insite')]
    for r in rows:
        assert r['errored'] is False
        assert np.isfinite([r['encoder_test_rmse_orig'],
                            r['decoder_test_rmse_6-step']]).all()
    assert all(r['global_equation_string'].count('Treatment') == 4
               for r in rows)
    assert 'Latex Table:: encoder_test_rmse_orig' in open(log_path).read()
