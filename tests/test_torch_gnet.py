"""The port's G-Net against the JAX package's on the CPU, on collections
made by the JAX package and handed over with
`convert.collection_from_numpy`.

- A whole gnet row of `run_experiment` (EQ_4_D and cancer_sim, 16 / 2 / 2
  patients, 2 epochs, dropout 0, one batch per epoch, 2 Monte-Carlo
  samples): the JAX package's initial parameters are loaded into the
  port's network before its fit; both fit in float32 with Adam. The
  holdout split is not empty (2 of 16 rows), so the n-step RMSEs hold the
  holdout residuals, the residual rows drawn in the JAX package's order and
  the noisy write-back of the Monte-Carlo rollout. The row has the JAX
  row's keys in its order, and its RMSEs agree to rtol 1e-4.
- The rollout's chunks change no number, and it writes into no array of
  the dataset.
- The initial weights come from the seed alone; a row run twice in one
  process is the same row.
- ``dim_vitals`` widens the features and adds the vitals head.
- `python -m insite_tpu_torch.run --device cpu --methods rmsn gnet edct` at
  a tiny size: the three rows in a log that the port's and the JAX
  package's readers read alike.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import insite_tpu.models.gnet as jax_gnet
import insite_tpu_torch.models.gnet as port_gnet
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.results import df_from_log
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu_torch import run
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.results import rows_from_log
from insite_tpu_torch.models.gnet import GNet, GNetConfig
from torch_handover import (RMSE_KEYS, SIZES, assert_rows_close,
                            build_with_initial, hand_over_jax_cohorts,
                            record_initial_params)

torch.set_num_threads(1)
OVERRIDES = {'gnet': {'dropout_rate': 0.0, 'batch_size': 4096}}


@pytest.mark.parametrize('dataset', ['EQ_4_D', 'cancer_sim'])
def test_gnet_row_matches_jax(monkeypatch, dataset):
    hand_over_jax_cohorts(monkeypatch)
    initial = []
    record_initial_params(monkeypatch, jax_gnet, 'fit_simple', initial)
    ref = jax_run_experiment(dataset, 'gnet', seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', epochs=2,
                                              gnet_mc_samples=2,
                                              model_overrides=OVERRIDES,
                                              **SIZES))
    assert len(initial) == 1
    models = []

    def nets_of(model):
        models.append(model)
        return [model.net]

    build_with_initial(monkeypatch, nets_of, initial)
    ours = runner.run_experiment(dataset, 'gnet', 0, 2.0,
                                 RunConfig(epochs=2, gnet_mc_samples=2,
                                           model_overrides=OVERRIDES,
                                           **SIZES),
                                 device='cpu', dtype=torch.float32)
    model, = models
    assert len(model.holdout_resid) == 2
    assert len(model.collection.train_f.data['outputs']) == 14
    assert len(model.collection.test_cf_treatment_seq_mc) == 2
    assert_rows_close(ours, ref, RMSE_KEYS + ['method', 'seed',
                                              'seconds_taken'],
                      f'gnet {dataset}')


def _fitted(monkeypatch):
    cfg = RunConfig(epochs=1, gnet_mc_samples=3, train_samples=24,
                    val_samples=2, test_samples=2)
    models = []
    build = runner._build_model

    def keep(*args, **kwargs):
        models.append(build(*args, **kwargs))
        return models[-1]

    monkeypatch.setattr(runner, '_build_model', keep)
    row = runner.run_experiment('EQ_4_D', 'gnet', 0, 2.0, cfg, device='cpu')
    return row, models[0]


def test_rollout_chunks_change_nothing(monkeypatch):
    """Chunks of 1,000 rows give the predictions of one chunk, and the
    views' arrays are left as they were."""
    _, model = _fitted(monkeypatch)
    views = model.collection.test_cf_treatment_seq_mc
    before = views[0].data['prev_outputs'].copy()
    whole = model.get_autoregressive_predictions(views)
    monkeypatch.setattr(port_gnet, 'CHUNK_ROWS', 1000)
    assert len(views) * len(before) > 2000
    np.testing.assert_array_equal(
        model.get_autoregressive_predictions(views), whole)
    np.testing.assert_array_equal(views[0].data['prev_outputs'], before)
    assert whole.shape == (len(before), 5, 1) and np.isfinite(whole).all()


def _state(seed):
    model = GNet(GNetConfig(seed=seed), SimpleNamespace(
        processed_data_multi=True, split_train_f_holdout=lambda r: None,
        explode_cf_treatment_seq=lambda m: None), device='cpu')
    return {k: v.clone() for k, v in model.net.state_dict().items()}


def test_gnet_weights_come_from_the_seed():
    first = _state(2)
    torch.rand(1000)
    again, other = _state(2), _state(3)
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert not all(torch.equal(first[k], other[k]) for k in first)


def test_gnet_row_is_reproducible_in_one_process(monkeypatch):
    first, _ = _fitted(monkeypatch)
    torch.rand(1000)
    again, _ = _fitted(monkeypatch)
    assert {k: again[k] for k in RMSE_KEYS} == {k: first[k]
                                                for k in RMSE_KEYS}


def test_vitals_are_not_ported_yet():
    """The vitals stream is ported: the features take it after the
    treatments, and the heads predict the outcome, then the vitals."""
    model = GNet(GNetConfig(dim_vitals=2), SimpleNamespace(
        processed_data_multi=True, split_train_f_holdout=lambda r: None,
        explode_cf_treatment_seq=lambda m: None), device='cpu')
    assert model.net.repr_net.weight_ih_l0.shape[1] == 1 + 2 + 1 + 2
    assert [o.out_features for o in
            model.net.r_outcome_vitals_head.out] == [1, 2]
    data = {'current_treatments': np.zeros((2, 4, 1)),
            'vitals': np.ones((2, 4, 2)),
            'prev_outputs': np.full((2, 4, 1), 2.0),
            'static_features': np.full((2, 2), 3.0)}
    assert port_gnet._inputs(data)[0, 0].tolist() == [0, 1, 1, 2, 3, 3]


def test_cli_serves_rmsn_gnet_and_edct(tmp_path):
    log_path = run.main(['--device', 'cpu', '--methods', 'rmsn', 'gnet',
                         'edct', '--datasets', 'cancer_sim', '--seeds', '1',
                         '--epochs', '1', '--train-samples', '24',
                         '--val-samples', '2', '--test-samples', '2',
                         '--log-dir', str(tmp_path)])
    rows = rows_from_log(log_path)
    # the JAX reader's frame has an sw_mode column: NaN on the rows without
    assert rows == [{k: v for k, v in r.items() if v == v}
                    for r in df_from_log(log_path).to_dict('records')]
    assert [(r['method_name'], r['errored']) for r in rows] == [
        ('rmsn', False), ('gnet', False), ('edct', False)]
    assert rows[0]['sw_mode'] == 'likelihood'
    assert all(np.isfinite(r['decoder_test_rmse_6-step']) for r in rows)
    assert 'Latex Table:: encoder_test_rmse_orig' in open(log_path).read()
