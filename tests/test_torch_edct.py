"""The port's EDCT against the JAX package's on the CPU, on collections made
by the JAX package and handed over with `convert.collection_from_numpy`.

- A whole edct row of `run_experiment` (EQ_4_D and cancer_sim, 16 / 2 / 2
  patients, 2 epochs, dropout 0, one batch per epoch in both stages: the
  decoder's batch is widened past its rolling-origin rows): the JAX
  package's initial parameters of the encoder and of the decoder are loaded
  into the port's networks before the fit; both fit in float32 with Adam.
  The row holds the whole pipeline: the transformer encoder's fit, the
  decoder processing that keeps the encoder's representations, their
  per-row gather, the decoder's fit (seed + 1) with attention over them,
  and step-by-step decoding. It has the JAX row's keys in its order, and
  its RMSEs agree to rtol 1e-4.
- The initial weights come from the seed alone: the encoder's from the
  seed, the decoder's from seed + 1; a row run twice in one process is
  the same row.
- A collection with a vitals stream widens the encoder's input by its
  width, taken from the collection; the decoder never takes it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import insite_tpu.models.crn as jax_crn
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.models.edct import EDCT, EDCTConfig, EDCTDecoderNetwork
from insite_tpu_torch.models.nn.training import seeded_net
from torch_handover import (RMSE_KEYS, SIZES, assert_rows_close,
                            build_with_initial, hand_over_jax_cohorts,
                            record_initial_params)

torch.set_num_threads(1)


@pytest.mark.parametrize('dataset', ['EQ_4_D', 'cancer_sim'])
def test_edct_row_matches_jax(monkeypatch, dataset):
    hand_over_jax_cohorts(monkeypatch)
    initial = []
    # EDCT's two stages train through the CRN module's fit_br_model
    record_initial_params(monkeypatch, jax_crn, 'fit_br_model', initial)
    overrides = {'edct': {'enc_dropout_rate': 0.0, 'dec_dropout_rate': 0.0,
                          'dec_batch_size': 4096}}
    ref = jax_run_experiment(dataset, 'edct', seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', epochs=2,
                                              model_overrides=overrides,
                                              **SIZES))
    assert len(initial) == 2
    models = []

    def nets_of(model):
        models.append(model)
        return [model.encoder.net, model.decoder.net]

    build_with_initial(monkeypatch, nets_of, initial)
    ours = runner.run_experiment(dataset, 'edct', 0, 2.0,
                                 RunConfig(epochs=2, model_overrides=overrides,
                                           **SIZES),
                                 device='cpu', dtype=torch.float32)
    model, = models
    assert model.encoder.train_cfg.batch_size >= SIZES['train_samples']
    assert model.decoder.train_cfg.batch_size >= len(
        model.collection.train_f.data['outputs'])
    assert_rows_close(ours, ref, RMSE_KEYS + ['method', 'seed',
                                              'seconds_taken'],
                      f'edct {dataset}')


def _states(seed):
    model = EDCT(EDCTConfig(seed=seed), SimpleNamespace(
        processed_data_encoder=True), device='cpu')
    return [{k: v.clone() for k, v in stage.net.state_dict().items()}
            for stage in (model.encoder, model.decoder)]


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_edct_weights_come_from_the_seed():
    enc, dec = _states(5)
    torch.rand(1000)
    enc_again, dec_again = _states(5)
    enc_other, _ = _states(6)
    assert _equal(enc, enc_again) and _equal(dec, dec_again)
    assert not _equal(enc, enc_other)
    dec_net = seeded_net(6, lambda: EDCTDecoderNetwork(EDCTConfig()), 'cpu')
    assert _equal(dec, dec_net.state_dict())


def test_edct_row_is_reproducible_in_one_process():
    cfg = RunConfig(epochs=2, train_samples=24, val_samples=2,
                    test_samples=2)
    rows = []
    for _ in range(2):
        rows.append(runner.run_experiment('EQ_4_D', 'edct', 0, 2.0, cfg,
                                          device='cpu'))
        torch.rand(1000)
    assert [{k: r[k] for k in RMSE_KEYS} for r in rows] == \
        [{k: rows[0][k] for k in RMSE_KEYS}] * 2


def _vitals_collection(**kw):
    """A processed collection whose training rows carry a 3-wide vitals
    stream."""
    return SimpleNamespace(has_vitals=True, train_f=SimpleNamespace(
        data={'vitals': np.zeros((4, 6, 3))}), **kw)


def test_vitals_are_not_ported_yet():
    """The vitals stream is ported: the encoder takes it."""
    model = EDCT(EDCTConfig(), _vitals_collection(
        processed_data_encoder=True), device='cpu')
    assert model.encoder.net.input.in_features == 2 + 3 + 1 + 2
    assert 'vitals' in model.encoder.keys
    assert model.decoder.net.input.in_features == 2 + 1 + 2
    assert 'vitals' not in model.decoder.keys
