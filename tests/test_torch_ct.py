"""The port's Causal Transformer against the JAX package's on the CPU, on
collections made by the JAX package and handed over with
`convert.collection_from_numpy`.

- A whole ct row of `run_experiment` (EQ_4_D and cancer_sim, 16 / 2 / 2
  patients, 2 epochs, dropout 0, one batch per epoch): the JAX package's
  initial parameters are loaded into the port's network before its fit;
  both fit in float32 with Adam. The row has the JAX row's keys in its
  order, and its RMSEs agree to rtol 1e-4 (largest deviation measured
  1.9e-07: float32 rounding through four Adam steps and the EMA).
  The RMSEs at all six horizons hold the prediction protocol: the EMA
  merged with the classifier's parameters, and the ``projection_horizon +
  1`` autoregressive passes.
- The initial weights come from the seed alone: two builds at one seed are
  equal whatever drew from PyTorch's global generator in between, two
  seeds differ, the global generator is left as it was, and a ct row
  (dropout on, several batches an epoch) run twice in one process is the
  same row.
- ``dim_vitals`` builds the vitals stream: its input projection, a
  vitals feed-forward layer a block, the optional batch keys and the
  masked-vitals augmentation.
"""

import pytest
import torch

import insite_tpu.models.ct as jax_ct
from insite_tpu.harness.config import RunConfig as JaxRunConfig
from insite_tpu.harness.runner import run_experiment as jax_run_experiment
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.models.ct import (CausalTransformer, CTConfig,
                                        ct_augment_fn)
from torch_handover import (RMSE_KEYS, SIZES, assert_rows_close,
                            build_with_initial, hand_over_jax_cohorts,
                            record_initial_params)

torch.set_num_threads(1)


@pytest.mark.parametrize('dataset', ['EQ_4_D', 'cancer_sim'])
def test_ct_row_matches_jax(monkeypatch, dataset):
    hand_over_jax_cohorts(monkeypatch)
    initial = []
    record_initial_params(monkeypatch, jax_ct, 'fit_br_model', initial)
    overrides = {'ct': {'dropout_rate': 0.0}}
    ref = jax_run_experiment(dataset, 'ct', seed=0, domain_conf=2.0,
                             cfg=JaxRunConfig(metrics_jsonl='', epochs=2,
                                              model_overrides=overrides,
                                              **SIZES))

    def nets_of(model):
        assert model.cfg.batch_size >= SIZES['train_samples']
        return [model.net]

    build_with_initial(monkeypatch, nets_of, initial)
    ours = runner.run_experiment(dataset, 'ct', 0, 2.0,
                                 RunConfig(epochs=2, model_overrides=overrides,
                                           **SIZES),
                                 device='cpu', dtype=torch.float32)
    assert_rows_close(ours, ref, RMSE_KEYS + ['method', 'seed',
                                              'seconds_taken'],
                      f'ct {dataset}')


def _state(model):
    return {k: v.clone() for k, v in model.net.state_dict().items()}


def test_ct_weights_come_from_the_seed():
    before = torch.random.get_rng_state()
    first = _state(CausalTransformer(CTConfig(seed=3), None, device='cpu'))
    assert torch.equal(torch.random.get_rng_state(), before)
    torch.rand(1000)
    again = _state(CausalTransformer(CTConfig(seed=3), None, device='cpu'))
    other = _state(CausalTransformer(CTConfig(seed=4), None, device='cpu'))
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert not all(torch.equal(first[k], other[k]) for k in first)


def test_ct_row_is_reproducible_in_one_process():
    cfg = RunConfig(epochs=2, model_overrides={'ct': {'batch_size': 8}},
                    train_samples=24, val_samples=2, test_samples=2)
    rows = []
    for _ in range(2):
        rows.append(runner.run_experiment('EQ_4_D', 'ct', 0, 2.0, cfg,
                                          device='cpu'))
        torch.rand(1000)
    assert [{k: r[k] for k in RMSE_KEYS} for r in rows] == \
        [{k: rows[0][k] for k in RMSE_KEYS}] * 2


def test_vitals_are_not_ported_yet():
    """The vitals stream is ported: ``dim_vitals`` builds it."""
    model = CausalTransformer(CTConfig(dim_vitals=3), None, device='cpu')
    assert model.net.vitals_input.in_features == 3
    assert model.net.block_0.ff_v is not None
    assert model.optional_keys == ('vitals', 'future_past_split')
    assert model.augment_fn is ct_augment_fn
    off = CausalTransformer(CTConfig(dim_vitals=3,
                                     augment_with_masked_vitals=False),
                            None, device='cpu')
    assert off.augment_fn is None
    plain = CausalTransformer(CTConfig(), None, device='cpu')
    assert plain.net.vitals_input is None and plain.optional_keys == ()
