"""The vitals stream of the neural baselines and `RealDatasetCollection`,
the port's against the JAX package's on the CPU (`tests/test_vitals.py`
and `tests/test_observability.py::test_real_dataset_collection` there).

- CT's block with three streams, in float64 from flax's parameters
  (`convert.state_dict_from_flax`), rtol 1e-10: its parameters are the
  two-stream block's plus ``ff_v``, and a call without vitals is the
  two-stream block's, bit for bit. The same for the CT network with
  vitals, masked from each row's split (``fixed_split``,
  ``future_past_split``) or not.
- `ct_augment_fn`: the doubled batch equals the JAX package's, given its
  split draws, exactly.
- Whole rows of ct, crn, rmsn, gnet and edct on a vitals collection (40 / 8
  / 8 EQ_4_D patients, seq 20, 2 epochs, f32), each from the JAX package's
  initial weights, dropout 0, one batch an epoch, ct's augmentation off:
  the 1-step RMSEs and the n-step RMSEs within rtol 1e-4.
- `RealDatasetCollection`'s multi-input and decoder processing: keys and
  values of every view equal the JAX package's within rtol 1e-12; its
  refusal of an unprocessed dataset.
- Zeroing the vitals changes a vitals-trained ct's predictions; exploding
  a vitals dataset threads the stream.
"""

import copy
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insite_tpu.models.crn as jax_crn
import insite_tpu.models.ct as jax_ct
import insite_tpu.models.edct as jax_edct
import insite_tpu.models.gnet as jax_gnet
import insite_tpu.models.rmsn as jax_rmsn
from insite_tpu.models.nn import blocks as jb
from insite_tpu_torch.convert import state_dict_from_flax
from insite_tpu_torch.data.dataset import SeqDataset
from insite_tpu_torch.models import crn, ct, edct, gnet, rmsn
from insite_tpu_torch.models.nn import blocks as tb
from torch_handover import (DIM_VITALS, jax_vitals_collection,
                            port_real_collection, record_initial_params)

torch.set_num_threads(1)
F64 = torch.float64
B, T = 5, 7
SIZES = {'train': 40, 'val': 8, 'test': 8}
SEQ = 20


def _close(ours, ref, what, rtol=1e-10, atol=1e-12):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else \
        np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, what
    dev = float(np.max(np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-12)))
    print(f'{what}: largest relative deviation {dev:.3e}')
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol, err_msg=what)


def _f64(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  params)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _active(lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]
            )[..., None].astype(np.float64)


def _streams(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 8), rng.randn(B, T, 8), rng.randn(B, 1, 8),
            rng.randn(B, T, 8), rng.randn(T, T, 4), rng.randn(T, T, 4))


def test_multi_input_block_vitals_on_off():
    """Three streams from flax's parameters; ``ff_v`` is the only new
    parameter; without vitals the block is the two-stream one, bit for
    bit, and equals the JAX two-stream block."""
    x_t, x_o, x_s, x_v, rel_k, rel_v = _streams(1)
    active = _active([T, 4, 2, 6, 1])
    # vitals masked from a split inside every row
    active_vitals = active * _active([3, 2, 0, 5, 1])
    ref_mod = jb.TransformerMultiInputBlock(8, 2, 4, 32, 0.1, 0.1, 15)
    params = _f64(ref_mod.init(jax.random.PRNGKey(1), x_t, x_o, x_s, active,
                               False, rel_k, rel_v, x_v=x_v,
                               active_vitals=active_vitals)['params'])
    ref = ref_mod.apply({'params': params}, x_t, x_o, x_s, active, False,
                        rel_k, rel_v, x_v=x_v, active_vitals=active_vitals)
    three = tb.TransformerMultiInputBlock(8, 2, 4, 32, 0.1, 0.1, True,
                                          dtype=F64)
    three.load_state_dict(state_dict_from_flax(params, three))
    args = (_t(x_t), _t(x_o), _t(x_s), _t(active), None, _t(rel_k),
            _t(rel_v))
    ours = three(*args, x_v=_t(x_v), active_vitals=_t(active_vitals))
    assert len(ours) == len(ref) == 3
    for name, o, r in zip('tov', ours, ref):
        _close(o, r, f'three-stream block {name}')

    two = tb.TransformerMultiInputBlock(8, 2, 4, 32, 0.1, 0.1, dtype=F64)
    extra = set(three.state_dict()) - set(two.state_dict())
    assert extra and all(k.startswith('ff_v.') for k in extra), extra
    two_params = {k: v for k, v in params.items() if k != 'ff_v'}
    two.load_state_dict(state_dict_from_flax(two_params, two))
    ref2 = ref_mod.apply({'params': two_params}, x_t, x_o, x_s, active,
                         False, rel_k, rel_v)
    for name, a, b, r in zip('to', three(*args), two(*args), ref2):
        assert torch.equal(a, b), name
        _close(a, r, f'two-stream block {name}')


@pytest.mark.parametrize('split_key', [None, 'fixed_split',
                                       'future_past_split'])
def test_ct_network_with_vitals(split_key):
    """The CT network over three streams, dropout off: vitals masked from
    each row's split, where the batch has one, and the representation
    averaging three streams before it and two after."""
    rng = np.random.RandomState(2)
    kw = dict(seq_hidden_units=8, br_size=4, fc_hidden_units=6, num_layer=2,
              max_relative_position=3, treatment_mode='multilabel',
              dim_vitals=DIM_VITALS)
    batch = {'prev_treatments': rng.rand(B, T, 2),
             'prev_outputs': rng.randn(B, T, 1),
             'static_features': rng.randn(B, 2),
             'current_treatments': rng.rand(B, T, 2),
             'active_entries': _active([T, 5, 3, 1, 6]),
             'vitals': rng.randn(B, T, DIM_VITALS)}
    if split_key is not None:
        batch[split_key] = np.array([4.0, 2.0, 0.0, 1.0, 7.0])
    ref_net = jax_ct.CTNetwork(jax_ct.CTConfig(**kw))
    params = _f64(ref_net.init(jax.random.PRNGKey(2), batch)['params'])
    assert 'vitals_input' in params and 'ff_v' in params['block_1']
    ref = ref_net.apply({'params': params}, batch, 0.4)
    net = ct.CTNetwork(ct.CTConfig(**kw), dtype=F64)
    net.load_state_dict(state_dict_from_flax(params, net))
    ours = net({k: _t(v) for k, v in batch.items()}, 0.4)
    for name, o, r in zip(('treatment', 'outcome', 'br'), ours, ref):
        _close(o, r, f'CT network with vitals, split {split_key}: {name}')


def test_ct_augment_fn_matches_jax():
    """Given the JAX package's split draws, the port doubles a batch as it
    does; the draws lie in 0..length, whole numbers."""
    rng = np.random.RandomState(3)
    batch = {'prev_outputs': rng.randn(B, T, 1).astype(np.float32),
             'vitals': rng.randn(B, T, 2).astype(np.float32),
             'active_entries': _active([T, 5, 3, 1, 6]).astype(np.float32)}
    ref = jax_ct.ct_augment_fn({k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(3))
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    ours = ct.double_with_split(
        tbatch, torch.as_tensor(np.array(ref['fixed_split'])[B:]))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    gen = torch.Generator().manual_seed(0)
    split = ct.masked_vitals_split(tbatch, gen)
    lengths = tbatch['active_entries'][..., 0].sum(1)
    assert torch.equal(split, split.floor())
    assert bool(((split >= 0) & (split <= lengths)).all())
    again = ct.ct_augment_fn(tbatch, torch.Generator().manual_seed(0))
    assert torch.equal(again['fixed_split'][B:], split)


# method -> (the JAX module whose fit the initial parameters are read from
# (EDCT's stages are crn's), that fit's name, the JAX and the port's
# estimator and config, config fields that turn dropout off and make every
# stage one batch an epoch)
ROWS = {
    'ct': (jax_ct, 'fit_br_model', jax_ct.CausalTransformer,
           jax_ct.CTConfig, ct.CausalTransformer, ct.CTConfig,
           dict(dropout_rate=0.0, batch_size=4096,
                augment_with_masked_vitals=False)),
    'crn': (jax_crn, 'fit_br_model', jax_crn.CRN, jax_crn.CRNConfig,
            crn.CRN, crn.CRNConfig,
            dict(enc_dropout_rate=0.0, dec_dropout_rate=0.0,
                 enc_batch_size=4096, dec_batch_size=1 << 15)),
    'rmsn': (jax_rmsn, 'fit_simple', jax_rmsn.RMSN, jax_rmsn.RMSNConfig,
             rmsn.RMSN, rmsn.RMSNConfig,
             dict(prop_treat_dropout=0.0, prop_hist_dropout=0.0,
                  enc_dropout=0.0, dec_dropout=0.0, prop_treat_bs=4096,
                  prop_hist_bs=4096, enc_bs=4096, dec_bs=1 << 15)),
    'gnet': (jax_gnet, 'fit_simple', jax_gnet.GNet, jax_gnet.GNetConfig,
             gnet.GNet, gnet.GNetConfig,
             dict(dropout_rate=0.0, batch_size=4096, mc_samples=2)),
    'edct': (jax_crn, 'fit_br_model', jax_edct.EDCT, jax_edct.EDCTConfig,
             edct.EDCT, edct.EDCTConfig,
             dict(enc_dropout_rate=0.0, dec_dropout_rate=0.0,
                  enc_batch_size=4096, dec_batch_size=1 << 15)),
}


def _config(cls, method, coll):
    d = coll.train_f.data
    fields = dict(epochs=2, seed=0, dim_outcome=d['outputs'].shape[-1],
                  dim_treatments=d['current_treatments'].shape[-1],
                  dim_static_features=d['static_features'].shape[-1],
                  **ROWS[method][-1])
    if method in ('ct', 'gnet'):
        fields['dim_vitals'] = d['vitals'].shape[-1]
    if method != 'gnet':
        fields['treatment_mode'] = 'multilabel'
    return cls(**fields)


def _networks(model):
    if hasattr(model, 'prop_treat'):                        # rmsn
        return [getattr(model, k).net for k in ('prop_treat', 'prop_hist',
                                                'encoder', 'decoder')]
    if hasattr(model, 'encoder'):                           # crn, edct
        return [model.encoder.net, model.decoder.net]
    return [model.net]                                      # ct, gnet


def _rmses(model, coll):
    one = model.get_normalised_masked_rmse(coll.test_cf_one_step)
    return np.array(list(one) + list(model.get_normalised_n_step_rmses(
        coll.test_cf_treatment_seq)))


@pytest.mark.parametrize('method', list(ROWS))
def test_row_on_vitals_collection_matches_jax(monkeypatch, method):
    module, fit_name, jax_cls, jax_cfg, port_cls, port_cfg, _ = ROWS[method]
    ref_coll = jax_vitals_collection(SIZES, SEQ)
    ours_coll = port_real_collection(ref_coll)
    initial = []
    record_initial_params(monkeypatch, module, fit_name, initial)
    ref_model = jax_cls(_config(jax_cfg, method, ref_coll), ref_coll)
    ref_model.fit(ref_coll.train_f, ref_coll.val_f)
    ref = _rmses(ref_model, ref_coll)

    model = port_cls(_config(port_cfg, method, ours_coll), ours_coll,
                     device='cpu', dtype=torch.float32)
    nets = _networks(model)
    assert len(nets) == len(initial)
    for net, params in zip(nets, initial):
        net.load_state_dict(state_dict_from_flax(params, net))
    if method in ('crn', 'edct'):
        assert 'vitals' in model.encoder.keys
        assert 'vitals' not in model.decoder.keys
    model.fit(ours_coll.train_f, ours_coll.val_f)
    if method == 'gnet':
        assert model.holdout_resid.shape[-1] == 1 + DIM_VITALS
        assert ref_model.holdout_resid.shape == model.holdout_resid.shape
    ours = _rmses(model, ours_coll)
    assert np.isfinite(ours).all()
    worst = float(np.max(np.abs(ours / ref - 1)))
    print(f'{method} on vitals: largest relative RMSE deviation '
          f'{worst:.3e}')
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


class _FakeEncoder:
    """Representations and predictions as fixed functions of the rows, the
    same in both packages."""

    def get_representations(self, ds):
        po = np.asarray(ds.data['prev_outputs'])
        return np.concatenate([np.tanh(po), 0.5 * po, po ** 2], axis=-1)

    def get_predictions(self, ds):
        return 0.9 * np.asarray(ds.data['prev_outputs'])


def _same_views(ours, ref, what):
    assert sorted(ours) == sorted(ref), what
    worst = 0.0
    for k in ref:
        a = np.asarray(ours[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0,
                                   err_msg=f'{what} {k}')
        if b.size:
            worst = max(worst, float(np.max(
                np.abs(a - b) / np.maximum(np.abs(b), 1e-300))))
    print(f'{what}: largest relative deviation {worst:.3e}')


@pytest.mark.parametrize('processing', ['multi', 'decoder'])
def test_real_dataset_collection_matches_jax(processing):
    ref = jax_vitals_collection(SIZES, SEQ)
    ours = port_real_collection(ref)
    assert ours.has_vitals and ref.has_vitals
    assert ours.test_cf_one_step is ours.test_f
    if processing == 'multi':
        ref.process_data_multi()
        ours.process_data_multi()
        assert ours.test_cf_treatment_seq is ours.test_f_multi
        assert 'future_past_split' in ours.test_f_multi.data
        _same_views(ours.test_f_multi.data, ref.test_f_multi.data,
                    'test_f_multi')
    else:
        ref.process_data_decoder(_FakeEncoder(), save_encoder_r=True)
        ours.process_data_decoder(_FakeEncoder(), save_encoder_r=True)
        for name in ('train_f', 'val_f', 'test_cf_treatment_seq'):
            _same_views(getattr(ours, name).data, getattr(ref, name).data,
                        name)
        np.testing.assert_allclose(ours.test_cf_treatment_seq.encoder_r,
                                   ref.test_cf_treatment_seq.encoder_r,
                                   rtol=1e-12)
    # test_f stays the raw factual rows of the 1-step RMSE
    _same_views(ours.test_f.data, ref.test_f.data, 'test_f')
    assert not ours.test_f.exploded


def test_real_dataset_collection_refuses_unprocessed_data():
    ds = SeqDataset({'current_covariates': np.zeros((2, 3, 1))}, 'train',
                    1.0)
    coll = port_real_collection(jax_vitals_collection(
        {'train': 8, 'val': 4, 'test': 4}, 10))
    coll.train_f = ds
    with pytest.raises(ValueError, match='processed'):
        coll.process_data_encoder()


def test_ct_vitals_change_predictions():
    """Zeroing the vitals changes a vitals-trained ct's predictions."""
    coll = port_real_collection(jax_vitals_collection(SIZES, SEQ))
    cfg = _config(ct.CTConfig, 'ct', coll)
    cfg = dataclasses.replace(cfg, batch_size=16, dropout_rate=0.1,
                              augment_with_masked_vitals=True)
    m = ct.CausalTransformer(cfg, coll, device='cpu').fit(coll.train_f)
    assert m.net.vitals_input is not None
    base = m.get_predictions(coll.test_cf_one_step)
    zeroed = copy.deepcopy(coll.test_cf_one_step)
    zeroed.data['vitals'] = np.zeros_like(zeroed.data['vitals'])
    assert np.isfinite(base).all()
    assert not np.allclose(base, m.get_predictions(zeroed))


def test_explode_threads_vitals():
    coll = port_real_collection(jax_vitals_collection(SIZES, SEQ))
    ds = copy.deepcopy(coll.test_f)
    n_before = ds.data['vitals'].shape[0]
    ds.explode_trajectories(5)
    assert ds.data['vitals'].shape[0] == ds.data['outputs'].shape[0] > \
        n_before
    assert ds.data['next_vitals'].shape[1] == ds.data['vitals'].shape[1] - 1


def test_vitals_width_comes_from_the_collection():
    """crn, rmsn and edct take the vitals width from the collection (their
    configs have no such field), before and after its decoder
    processing."""
    coll = port_real_collection(jax_vitals_collection(
        {'train': 8, 'val': 4, 'test': 4}, 10))
    from insite_tpu_torch.models.base import collection_vitals_width
    assert collection_vitals_width(coll) == DIM_VITALS
    assert collection_vitals_width(SimpleNamespace()) == 0
    coll.process_data_decoder(_FakeEncoder())
    assert 'vitals' not in coll.train_f.data
    assert collection_vitals_width(coll) == DIM_VITALS
    enc = edct.EDCT(edct.EDCTConfig(), coll, device='cpu').encoder.net
    assert enc.input.in_features == 2 + DIM_VITALS + 1 + 2
