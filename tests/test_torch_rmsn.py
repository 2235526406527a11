"""The port's RMSN against the JAX package's on the CPU, on collections made
by the JAX package and handed over with `convert.collection_from_numpy`.

- A whole rmsn row of `run_experiment` (16 / 2 / 2 patients, 2 epochs, the
  encoder 6, dropout 0, one batch per epoch in all four networks: the
  decoder's batch is widened past its rolling-origin rows), in both
  ``sw_mode``s, 'likelihood' on EQ_4_D and 'score_ratio' on cancer_sim:
  the JAX package's initial parameters of the four networks are loaded
  into the port's before the fit; both fit in float32 with Adam. The row
  holds the whole pipeline: both propensity fits, the stabilized weights
  and their clip, the weighted encoder, the decoder processing from the
  encoder's representations, the warm-started decoder and step-by-step
  decoding. It has the JAX row's keys in its order (``sw_mode`` among
  them), and its RMSEs agree to rtol 1e-4.
- The clip of the stabilized weights against the JAX package's, float64.
- The initial weights come from the seed alone: the four networks' from
  seed .. seed + 3, equal at one seed whatever drew from PyTorch's global
  generator in between; a row run twice in one process is the same row.
- A collection with a vitals stream widens the propensity-history
  network's and the encoder's input by its width, taken from the
  collection.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import insite_tpu.models.rmsn as jax_rmsn
import insite_tpu_torch.models.rmsn as port_rmsn
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.models.rmsn import (LSTMOutputNet, RMSN, RMSNConfig,
                                          clip_normalize_stabilized_weights)
from insite_tpu_torch.models.nn.training import seeded_net
from torch_handover import (RMSE_KEYS, SIZES, assert_rows_close,
                            build_with_initial, hand_over_jax_cohorts,
                            record_initial_params)

torch.set_num_threads(1)
NETS = ('prop_treat', 'prop_hist', 'encoder', 'decoder')


def _nets(model):
    return [getattr(model, name).net for name in NETS]


@pytest.mark.parametrize('dataset,sw_mode', [('EQ_4_D', 'likelihood'),
                                             ('cancer_sim', 'score_ratio')])
def test_rmsn_row_matches_jax(monkeypatch, dataset, sw_mode):
    hand_over_jax_cohorts(monkeypatch)
    initial = []
    record_initial_params(monkeypatch, jax_rmsn, 'fit_simple', initial)
    overrides = {'rmsn': {'prop_treat_dropout': 0.0,
                          'prop_hist_dropout': 0.0, 'enc_dropout': 0.0,
                          'dec_dropout': 0.0, 'prop_treat_bs': 64,
                          'enc_bs': 64, 'dec_bs': 4096, 'sw_mode': sw_mode}}
    ref = jax_run_experiment(dataset, 'rmsn', seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', epochs=2,
                                              model_overrides=overrides,
                                              **SIZES))
    assert len(initial) == 4
    build_with_initial(monkeypatch, _nets, initial)
    fits = []
    fit = port_rmsn.fit_simple

    def one_batch_an_epoch(net, loss_fn, data, cfg, gen):
        n = len(next(iter(data.values())))
        fits.append((cfg.epochs, n <= cfg.batch_size))
        return fit(net, loss_fn, data, cfg, gen)

    monkeypatch.setattr(port_rmsn, 'fit_simple', one_batch_an_epoch)
    ours = runner.run_experiment(dataset, 'rmsn', 0, 2.0,
                                 RunConfig(epochs=2, model_overrides=overrides,
                                           **SIZES),
                                 device='cpu', dtype=torch.float32)
    assert fits == [(2, True), (2, True), (6, True), (2, True)]
    assert ours['sw_mode'] == ref['sw_mode'] == sw_mode
    assert_rows_close(ours, ref, RMSE_KEYS + ['sw_mode', 'method', 'seed',
                                              'seconds_taken'],
                      f'rmsn {dataset} {sw_mode}')


@pytest.mark.parametrize('multiple_horizons', [False, True])
def test_clip_normalize_stabilized_weights(multiple_horizons):
    rng = np.random.RandomState(0)
    sw = np.exp(rng.randn(40, 6) * 2)
    active = (rng.rand(40, 6, 1) < 0.8) * 1.0
    ours = clip_normalize_stabilized_weights(sw, active, multiple_horizons)
    ref = jax_rmsn.clip_normalize_stabilized_weights(sw, active,
                                                     multiple_horizons)
    np.testing.assert_allclose(ours, ref, rtol=1e-15)
    assert (ours[active[..., 0] == 0] == 0).all()


def _states(seed):
    model = RMSN(RMSNConfig(seed=seed), SimpleNamespace(
        processed_data_encoder=True), device='cpu')
    return [{k: v.clone() for k, v in net.state_dict().items()}
            for net in _nets(model)]


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_rmsn_weights_come_from_the_seed():
    first = _states(5)
    torch.rand(1000)
    again = _states(5)
    assert all(_equal(a, b) for a, b in zip(first, again))
    assert not _equal(first[0], _states(6)[0])
    # network i from seed + i alone: the decoder (i = 3) at seed 5 is the
    # network a build from seed 8 gives
    cfg = RMSNConfig()
    n_in = cfg.dim_treatments + cfg.dim_outcome + cfg.dim_static_features
    decoder = seeded_net(8, lambda: LSTMOutputNet(
        n_in, cfg.dec_hidden, cfg.dim_outcome, cfg.dec_dropout,
        memory_size=cfg.enc_hidden), 'cpu')
    assert _equal(first[3], decoder.state_dict())


def test_rmsn_row_is_reproducible_in_one_process():
    cfg = RunConfig(epochs=2, train_samples=24, val_samples=2,
                    test_samples=2)
    rows = []
    for _ in range(2):
        rows.append(runner.run_experiment('EQ_4_D', 'rmsn', 0, 2.0, cfg,
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
    """The vitals stream is ported: the propensity-history network and
    the encoder take it."""
    model = RMSN(RMSNConfig(), _vitals_collection(
        processed_data_encoder=True), device='cpu')
    widths = [getattr(model, k).net.lstm.weight_ih_l0.shape[1]
              for k in ('prop_treat', 'prop_hist', 'encoder', 'decoder')]
    assert widths == [1, 1 + 1 + 2 + 3, 1 + 1 + 2 + 3, 1 + 1 + 2]
    data = {'prev_treatments': np.zeros((2, 4, 1)),
            'current_treatments': np.ones((2, 4, 1)),
            'prev_outputs': np.full((2, 4, 1), 2.0),
            'static_features': np.full((2, 2), 3.0),
            'vitals': np.full((2, 4, 3), 4.0)}
    assert port_rmsn._propensity_inputs_hist(data)[0, 0].tolist() == \
        [0, 4, 4, 4, 2, 3, 3]
    assert port_rmsn._encoder_inputs(data)[0, 0].tolist() == \
        [4, 4, 4, 2, 1, 3, 3]
