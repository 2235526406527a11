"""Seed stacking changes no arithmetic: the port's blocks, trainers and
vectorized columns with a seed axis against their one-seed versions, on
the CPU.

- `lstm_step` (with `lstm_input_gates`) equals `torch.lstm_cell` (f64,
  rtol 1e-12); the `GradReverse` gradient under `torch.func.vmap` equals
  the per-seed gradients; each network (CT, CRN's encoder and decoder,
  EDCT's encoder and decoder, RMSN's LSTM with and without its memory
  adapter, G-Net) vmapped over S = 3 stacked parameter sets equals S plain
  forwards (f64, rtol 1e-10); with dropout on, the seeds' masks differ.
- `fit_br_column` (CT, and CRN's grad-reverse balancing) and
  `fit_simple_column` (RMSN's network, G-Net) over S = 3 seeds equal three
  `fit_br_model` / `fit_simple` runs, seed by seed (f64, dropout 0, one
  batch an epoch, rows zero-padded to the longest seed, clipping on at
  RMSN's values so that the per-seed norm is what is tested, and the EMA
  on in the BR fits; rtol 1e-8).
- A column repeats bit for bit in one process (ct and crn); its
  ``model_overrides`` win over its ``epochs``, and an unknown RMSN
  ``sw_mode`` raises.
- ``run.py --vectorized`` on the neural methods: per seed a row with the
  JAX runner's keys in its order (rmsn rows with ``sw_mode``), from
  ``--seed-start``, that `rows_from_log` reads back.
"""

import numpy as np
import pytest
import torch

from insite_tpu_torch import run
from insite_tpu_torch.harness import vectorized_neural
from insite_tpu_torch.harness.results import rows_from_log
from insite_tpu_torch.models import crn, ct, edct, gnet, rmsn
from insite_tpu_torch.models.nn import training
from insite_tpu_torch.models.nn.blocks import (grad_reverse,
                                               lstm_input_gates, lstm_step)

torch.set_num_threads(1)

F64 = torch.float64
S, N, T = 3, 10, 7


def _seq_batch(rng, n, t=T, dtype=F64, dec=False):
    b = {'prev_treatments': rng.rand(n, t, 2),
         'prev_outputs': rng.randn(n, t, 1),
         'static_features': rng.randn(n, 2),
         'current_treatments': (rng.rand(n, t, 2) > 0.5) * 1.0,
         'outputs': rng.randn(n, t, 1),
         'active_entries': np.ones((n, t, 1))}
    b['active_entries'][:, t - 2:] = 0.0
    if dec:
        b['encoder_r'] = rng.randn(n, 9, 6)
        b['active_encoder_r'] = np.ones((n, 9))
        b['init_state'] = rng.randn(n, 6)
    return {k: torch.tensor(v, dtype=dtype) for k, v in b.items()}


def _nets(build, seeds=range(S)):
    return [training.seeded_net(s, build, 'cpu') for s in seeds]


def test_lstm_step_matches_lstm_cell():
    rng = np.random.RandomState(0)
    B, I, H = 5, 4, 6
    x, h, c = (torch.tensor(rng.randn(B, d), dtype=F64) for d in (I, H, H))
    w_ih, w_hh = (torch.tensor(rng.randn(4 * H, d), dtype=F64)
                  for d in (I, H))
    b_ih, b_hh = (torch.tensor(rng.randn(4 * H), dtype=F64) for _ in '..')
    got = lstm_step(lstm_input_gates(x, w_ih, b_ih, b_hh), h, c, w_hh)
    want = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-15)


def test_grad_reverse_under_vmap():
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(S, 4, 3), dtype=F64, requires_grad=True)
    w = torch.tensor(rng.randn(S, 3), dtype=F64)
    scale = torch.tensor(0.7, dtype=F64)

    def loss(x_s, w_s):
        return (grad_reverse(x_s, scale) ** 2 * w_s).sum()

    g, = torch.autograd.grad(torch.func.vmap(loss)(x, w).sum(), x)
    for s in range(S):
        xs = x[s].detach().requires_grad_()
        want, = torch.autograd.grad(loss(xs, w[s]), xs)
        np.testing.assert_allclose(g[s].numpy(), want.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), (-0.7 * 2 * x * w[:, None]).detach()
                               .numpy(), rtol=1e-12)


def _ct_cfg(**kw):
    return ct.CTConfig(treatment_mode='multilabel', **kw)


def _crn_cfg(**kw):
    return crn.CRNConfig(treatment_mode='multilabel', enc_br_size=6, **kw)


def _edct_cfg(**kw):
    return edct.EDCTConfig(treatment_mode='multilabel', enc_br_size=6, **kw)


def _rmsn_cfg(**kw):
    return rmsn.RMSNConfig(dim_treatments=2, enc_hidden=6, **kw)


def _gnet_cfg(**kw):
    return gnet.GNetConfig(dim_treatments=2, **kw)


def _x(b):
    """[current_treatments, prev_outputs, statics] (RMSN, G-Net)."""
    statics = b['static_features'].unsqueeze(-2).expand(
        *b['prev_outputs'].shape[:-1], -1)
    return torch.cat([b['current_treatments'], b['prev_outputs'], statics],
                     -1)


# name -> (network factory, dec batch?, forward args of a batch, output)
NETWORKS = {
    'ct': (lambda **kw: ct.CTNetwork(_ct_cfg(**kw), dtype=F64), False,
           lambda b: (b,), 1),
    'crn_encoder': (lambda **kw: crn.encoder_network(_crn_cfg(**kw), F64),
                    False, lambda b: (b,), 1),
    'crn_decoder': (lambda **kw: crn.decoder_network(_crn_cfg(**kw), F64),
                    True, lambda b: (b,), 1),
    'edct_encoder': (lambda **kw: edct.encoder_network(_edct_cfg(**kw), F64),
                     False, lambda b: (b,), 1),
    'edct_decoder': (lambda **kw: edct.decoder_network(_edct_cfg(**kw), F64),
                     True, lambda b: (b,), 1),
    'rmsn_encoder': (lambda **kw: rmsn.network_factories(
        _rmsn_cfg(**kw), F64)[2](), False, lambda b: (_x(b),), 0),
    'rmsn_decoder': (lambda **kw: rmsn.network_factories(
        _rmsn_cfg(**kw), F64)[3](), True,
        lambda b: (_x(b), b['init_state']), 0),
    'gnet': (lambda **kw: gnet.GNetNetwork(_gnet_cfg(**kw), dtype=F64),
             False, lambda b: (_x(b),), None),
}


def _output(out, which):
    return out if which is None else out[which]


@pytest.mark.parametrize('name', sorted(NETWORKS))
def test_vmapped_forward_matches_plain(name):
    build, dec, args_of, which = NETWORKS[name]
    nets = _nets(build)
    rng = np.random.RandomState(2)
    batches = [_seq_batch(rng, N, dec=dec) for _ in range(S)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    base, params = training.stack_nets(nets)
    with torch.no_grad():
        got = _output(training.stacked_call(base, params,
                                            args_of(stacked)), which)
        for s in range(S):
            want = _output(nets[s](*args_of(batches[s])), which)
            np.testing.assert_allclose(got[s].numpy(), want.numpy(),
                                       rtol=1e-10, atol=1e-12, err_msg=name)


@pytest.mark.parametrize('name', ['crn_encoder', 'gnet'])
def test_dropout_masks_differ_between_seeds(name):
    """The same parameters and batch for every seed, dropout on: each seed
    draws its own masks from the one generator."""
    build, dec, args_of, which = NETWORKS[name]
    net = build(**({'enc_dropout_rate': 0.5} if name == 'crn_encoder'
                   else {'dropout_rate': 0.5}))
    base, params = training.stack_nets([net] * S)
    batch = _seq_batch(np.random.RandomState(3), N, dec=dec)
    stacked = {k: torch.stack([batch[k]] * S) for k in batch}
    gen = torch.Generator().manual_seed(0)

    def one(p, a):
        return torch.func.functional_call(base, p, a, {'gen': gen})

    with torch.no_grad():
        out = _output(torch.func.vmap(one, randomness='different')(
            params, args_of(stacked)), which)
        plain = _output(net(*args_of(batch)), which)
    for s in range(S):
        assert not torch.equal(out[s], plain)
        for r in range(s):
            assert not torch.equal(out[s], out[r])


def _padded(batches):
    n = max(len(b['outputs']) for b in batches)
    return {k: torch.stack([torch.cat([b[k], b[k].new_zeros(
        (n - len(b[k]),) + b[k].shape[1:])]) for b in batches])
        for k in batches[0]}


def _assert_seedwise(params, nets, what, ema=None, emas=None):
    for s, net in enumerate(nets):
        for k, p in net.named_parameters():
            np.testing.assert_allclose(params[k][s].detach().numpy(),
                                       p.detach().numpy(), rtol=1e-8,
                                       atol=1e-12, err_msg=f'{what} {k}')
            if ema is not None:
                np.testing.assert_allclose(ema[k][s].numpy(),
                                           emas[s][k].numpy(), rtol=1e-8,
                                           atol=1e-12,
                                           err_msg=f'{what} EMA {k}')


@pytest.mark.parametrize('name', ['ct', 'crn_encoder'])
def test_fit_br_column_equals_per_seed_fits(name):
    build, dec, _, _ = NETWORKS[name]
    kw = ({'dropout_rate': 0.0} if name == 'ct' else
          {'enc_dropout_rate': 0.0, 'balancing': 'grad_reverse',
           'alpha': 1.0})
    nets = _nets(lambda: build(**kw))
    rng = np.random.RandomState(4)
    batches = [_seq_batch(rng, N - s, dec=dec) for s in range(S)]
    tc = training.TrainConfig(epochs=3, batch_size=64, learning_rate=0.01,
                              max_grad_norm=rmsn.RMSNConfig.dec_clip,
                              weights_ema=True, alpha=kw.get('alpha', 0.01),
                              balancing=kw.get('balancing',
                                               'domain_confusion'),
                              treatment_mode='multilabel')
    base, params = training.stack_nets(nets)
    ema = training.fit_br_column(base, params, _padded(batches), tc,
                                 torch.Generator().manual_seed(0))
    emas = []
    for s, net in enumerate(nets):
        emas.append(training.fit_br_model(net, batches[s], tc,
                                          torch.Generator().manual_seed(s)))
    _assert_seedwise(params, nets, name, ema, emas)


@pytest.mark.parametrize('name', ['rmsn_decoder', 'gnet'])
def test_fit_simple_column_equals_per_seed_fits(name):
    build, dec, args_of, which = NETWORKS[name]
    nets = _nets(lambda: build(**({'dec_dropout': 0.0} if name != 'gnet'
                                  else {'dropout_rate': 0.0})))
    rng = np.random.RandomState(5)
    batches = []
    for s in range(S):
        b = _seq_batch(rng, N - s, dec=dec)
        batches.append({'x': _x(b), 'outputs': b['outputs'],
                        'active_entries': b['active_entries'],
                        **({'init_state': b['init_state']} if dec else {})})

    def loss_fn(net, b, gen):
        args = (b['x'], b['init_state']) if dec else (b['x'],)
        out = _output(net(*args, gen=gen), which)[..., :1]
        return training.masked_mean((out - b['outputs']) ** 2,
                                    b['active_entries'])

    tc = training.TrainConfig(epochs=3, batch_size=64, learning_rate=0.01,
                              max_grad_norm=rmsn.RMSNConfig.prop_hist_clip)
    base, params = training.stack_nets(nets)
    training.fit_simple_column(base, params, loss_fn, _padded(batches), tc,
                               torch.Generator().manual_seed(0))
    for s, net in enumerate(nets):
        training.fit_simple(net, loss_fn, batches[s], tc,
                            torch.Generator().manual_seed(s))
    _assert_seedwise(params, nets, name)


SMALL = dict(n_seeds=2, num_patients={'train': 12, 'val': 2, 'test': 2},
             epochs=1, max_seq_length=20, device='cpu')


@pytest.mark.parametrize('sweep', [
    lambda: vectorized_neural.vectorized_ct_sweep('EQ_4_D', **SMALL),
    lambda: vectorized_neural.vectorized_enc_dec_sweep('crn', 'EQ_4_D',
                                                       **SMALL)],
    ids=['ct', 'crn'])
def test_column_repeats_bit_for_bit(sweep):
    first, again = sweep(), sweep()
    assert list(first) == list(again)
    for k in first:
        assert np.array_equal(first[k], again[k]), k


def test_column_overrides_and_sw_mode():
    """A column's ``model_overrides`` win over its ``epochs``, as in the
    standard path; an unknown RMSN ``sw_mode`` raises, as there too."""
    once = vectorized_neural.vectorized_enc_dec_sweep('crn', 'EQ_4_D',
                                                      **SMALL)
    over = vectorized_neural.vectorized_enc_dec_sweep(
        'crn', 'EQ_4_D', **dict(SMALL, epochs=50),
        model_overrides={'epochs': 1})
    for k in once:
        assert np.array_equal(once[k], over[k]), k
    with pytest.raises(ValueError, match="unknown sw_mode 'ratio'"):
        vectorized_neural.vectorized_rmsn_sweep(
            'EQ_4_D', **SMALL, model_overrides={'sw_mode': 'ratio'})


VECTORIZED_ROW_KEYS = (
    ['encoder_test_rmse_orig', 'encoder_test_rmse_all',
     'encoder_test_rmse_last'] +
    [f'decoder_test_rmse_{k}-step' for k in range(2, 7)] +
    ['method', 'seed', 'seconds_taken', 'vectorized', 'errored',
     'dataset_name', 'method_name', 'domain_conf'])


def test_cli_vectorized_neural_rows(tmp_path):
    """The JAX runner's vectorized row: the column's metrics in its order,
    then method .. domain_conf, and on rmsn rows ``sw_mode`` last."""
    log_path = run.main(['--vectorized', '--device', 'cpu', '--methods',
                         'ct', 'rmsn', '--datasets', 'EQ_4_D', '--seeds', '2',
                         '--seed-start', '3', '--epochs', '1',
                         '--train-samples', '12', '--val-samples', '2',
                         '--test-samples', '2', '--log-dir', str(tmp_path)])
    rows = rows_from_log(log_path)
    assert [(r['method_name'], r['seed']) for r in rows] == [
        ('ct', 3), ('ct', 4), ('rmsn', 3), ('rmsn', 4)]
    for r in rows:
        keys = VECTORIZED_ROW_KEYS + (['sw_mode'] if r['method'] == 'rmsn'
                                      else [])
        assert list(r) == keys
        assert r['vectorized'] is True and r['errored'] is False
        assert np.isfinite(r['decoder_test_rmse_6-step'])
    assert rows[2]['sw_mode'] == 'likelihood'
    assert rows[0]['seconds_taken'] == rows[1]['seconds_taken']
