"""The port's CRN against the JAX package's on the CPU, on collections made
by the JAX package and handed over with `convert.collection_from_numpy`.

- A whole crn row of `run_experiment` (EQ_4_D and cancer_sim, 16 / 2 / 2
  patients, 2 epochs, dropout 0, one batch per epoch in both stages: the
  decoder's batch is widened past its rolling-origin rows): the JAX
  package's initial parameters of the encoder and of the decoder are loaded
  into the port's networks before the fit; both fit in float32 with Adam.
  The encoder's representations start the decoder's rows, so the row holds
  the whole pipeline: encoder fit, decoder processing, decoder fit (seed +
  1) and step-by-step decoding. It has the JAX row's keys in its order, and
  its RMSEs agree to rtol 1e-4.
- `python -m insite_tpu_torch.run --device cpu --methods ct crn` at a tiny
  size: both rows in a log that the port's and the JAX package's readers
  read alike.
- The initial weights come from the seed alone: the encoder's from the
  seed, the decoder's from seed + 1, equal at one seed whatever drew from
  PyTorch's global generator in between; a crn row run again after a ct
  row in one process is the same row.
- A collection with a vitals stream widens the encoder's input by its
  width, taken from the collection; the decoder never takes it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import insite_tpu.models.crn as jax_crn
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.results import df_from_log
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu_torch import run
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.results import rows_from_log
from insite_tpu_torch.models.crn import CRN, CRNConfig, CRNSubNetwork
from insite_tpu_torch.models.nn.training import seeded_net
from torch_handover import (RMSE_KEYS, SIZES, assert_rows_close,
                            build_with_initial, hand_over_jax_cohorts,
                            record_initial_params)

torch.set_num_threads(1)


@pytest.mark.parametrize('dataset', ['EQ_4_D', 'cancer_sim'])
def test_crn_row_matches_jax(monkeypatch, dataset):
    hand_over_jax_cohorts(monkeypatch)
    initial = []
    record_initial_params(monkeypatch, jax_crn, 'fit_br_model', initial)
    overrides = {'crn': {'enc_dropout_rate': 0.0, 'dec_dropout_rate': 0.0,
                         'dec_batch_size': 4096}}
    ref = jax_run_experiment(dataset, 'crn', seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', epochs=2,
                                              model_overrides=overrides,
                                              **SIZES))
    assert len(initial) == 2
    models = []

    def nets_of(model):
        models.append(model)
        return [model.encoder.net, model.decoder.net]

    build_with_initial(monkeypatch, nets_of, initial)
    ours = runner.run_experiment(dataset, 'crn', 0, 2.0,
                                 RunConfig(epochs=2, model_overrides=overrides,
                                           **SIZES),
                                 device='cpu', dtype=torch.float32)
    # one batch per epoch in both stages
    model, = models
    assert model.encoder.train_cfg.batch_size >= SIZES['train_samples']
    assert model.decoder.train_cfg.batch_size >= len(
        model.collection.train_f.data['outputs'])
    assert_rows_close(ours, ref, RMSE_KEYS + ['method', 'seed',
                                              'seconds_taken'],
                      f'crn {dataset}')


def test_cli_serves_ct_and_crn(tmp_path):
    log_path = run.main(['--device', 'cpu', '--methods', 'ct', 'crn',
                         '--datasets', 'cancer_sim', '--seeds', '1',
                         '--epochs', '1', '--train-samples', '24',
                         '--val-samples', '2', '--test-samples', '2',
                         '--log-dir', str(tmp_path)])
    rows = rows_from_log(log_path)
    assert rows == df_from_log(log_path).to_dict('records')
    assert [(r['method_name'], r['errored']) for r in rows] == [
        ('ct', False), ('crn', False)]
    assert all(np.isfinite(r['decoder_test_rmse_6-step']) for r in rows)
    assert 'Latex Table:: encoder_test_rmse_orig' in open(log_path).read()


def _states(seed):
    crn = CRN(CRNConfig(seed=seed), SimpleNamespace(
        processed_data_encoder=True), device='cpu')
    return [{k: v.clone() for k, v in stage.net.state_dict().items()}
            for stage in (crn.encoder, crn.decoder)]


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_crn_weights_come_from_the_seed():
    enc, dec = _states(5)
    torch.rand(1000)
    enc_again, dec_again = _states(5)
    enc_other, _ = _states(6)
    assert _equal(enc, enc_again) and _equal(dec, dec_again)
    assert not _equal(enc, enc_other)
    cfg = CRNConfig()
    dec_net = seeded_net(6, lambda: CRNSubNetwork(
        cfg.enc_br_size, cfg.dec_br_size, cfg.dec_fc_hidden_units,
        cfg.dim_treatments, cfg.dim_outcome, cfg.dim_static_features,
        cfg.dec_dropout_rate, cfg.num_layer, cfg.balancing, True), 'cpu')
    assert _equal(dec, dec_net.state_dict())


def test_crn_row_does_not_depend_on_earlier_runs():
    cfg = RunConfig(epochs=2, train_samples=24, val_samples=2,
                    test_samples=2)
    first = runner.run_experiment('EQ_4_D', 'crn', 0, 2.0, cfg, device='cpu')
    runner.run_experiment('EQ_4_D', 'ct', 0, 2.0, cfg, device='cpu')
    torch.rand(1000)
    again = runner.run_experiment('EQ_4_D', 'crn', 0, 2.0, cfg, device='cpu')
    assert {k: again[k] for k in RMSE_KEYS} == {k: first[k] for k in RMSE_KEYS}


def _vitals_collection(**kw):
    """A processed collection whose training rows carry a 3-wide vitals
    stream."""
    return SimpleNamespace(has_vitals=True, train_f=SimpleNamespace(
        data={'vitals': np.zeros((4, 6, 3))}), **kw)


def test_vitals_are_not_ported_yet():
    """The vitals stream is ported: the encoder takes it."""
    model = CRN(CRNConfig(), _vitals_collection(processed_data_encoder=True),
                device='cpu')
    assert model.encoder.net.lstm.weight_ih_l0.shape[1] == 2 + 3 + 1 + 2
    assert 'vitals' in model.encoder.keys and \
        'vitals' in model.encoder.input_keys
    assert model.decoder.net.lstm.weight_ih_l0.shape[1] == 2 + 1 + 2
    assert 'vitals' not in model.decoder.keys
